"""Planted faults of the tensor-parallel path, for the checks that must
show their limits catch them (``chip_smoke.py`` phase 13 and the CPU tests
of ``parallel/tensor.py``).

Each fault swaps one function of the path for a wrong one while its
context is open, in this process only:
  * "no all-reduce after a row-parallel conv": ``reduce_out`` returns its
    input, so an input-channel-split conv's partial sums stay partial;
  * "identity backward in place of copy in": ``copy_in`` is the identity
    both ways, so an output-channel-split conv's input gradient is not
    summed over the model group;
  * "strip term without its share": a part strip's triplet term is summed
    over the model group without its P_r / 62 weight.
"""

import contextlib

from ugaitnet_tpu_torch.models import gaitset
from ugaitnet_tpu_torch.train import train_step

TP_FAULTS = ("no all-reduce after a row-parallel conv",
             "identity backward in place of copy in",
             "strip term without its share")


@contextlib.contextmanager
def tp_planted(name: str):
    """One of TP_FAULTS planted in this process's modules."""
    mod, attr, fn = {
        TP_FAULTS[0]: (gaitset, "reduce_out", lambda x, group: x),
        TP_FAULTS[1]: (gaitset, "copy_in", lambda x, group: x),
        TP_FAULTS[2]: (train_step, "strip_share", lambda strip, parts: 1.0),
    }[name]
    old = getattr(mod, attr)
    setattr(mod, attr, fn)
    try:
        yield
    finally:
        setattr(mod, attr, old)
