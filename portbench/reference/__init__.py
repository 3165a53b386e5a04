"""The plain reference that decides ``correct``: the instrument's banks and
weights (``instrument``), the forward model as plain sums (``forward``) and
the comparison with its control (``check``).  Imports torch and numpy only,
and nothing of the program under test."""
