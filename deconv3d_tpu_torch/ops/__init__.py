from .fsf_factor import factor_bank

__all__ = ["factor_bank"]
