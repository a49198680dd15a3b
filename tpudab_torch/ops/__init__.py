"""Device kernels and their plain torch twins (counterpart of tpudab.ops)."""

from tpudab_torch.ops.viterbi import pad_mother_soft
