"""Host seconds of the FSF bank at every λ and its rank-S factorisation
(the port's span ``setup.fsf_bank``, inside ``setup.problem``): the set-up
that a chromatic FSF adds.  None without the span."""

from portbench import spans


def read(ctx):
    return spans.total_s(ctx, "setup.fsf_bank")
