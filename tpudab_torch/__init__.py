"""tpudab_torch — the PyTorch/CUDA port of tpudab: the receive step
(models/step.py) and the host per-stage path behind decode-bits
(models/receiver.py, host/cli.py).

The package mirrors tpudab's layout (audio/, data/, database/, fec/, fic/,
host/, models/, mot/, msc/, ofdm/, ops/, pad/, synth/, utils/), so each
module's counterpart sits at the same path. It imports torch and numpy
and never jax: from tpudab it takes only the pure numpy modules
tpudab.constants.* and tpudab.msc.interleave. Everything else it needs is
written again here without jax, and held equal to its tpudab counterpart
by the tests/test_torch_*.py parity tests.

Every Pallas kernel on those paths has a hand-written CUDA C++ counterpart
for sm_90a under csrc/, built on first use (ops/_build.py).
Each kernel's wrapper dispatches on the tensor's device alone: a CPU tensor
takes the plain torch version beside it, a CUDA tensor launches the kernel.
"""

__version__ = "0.1.0"
