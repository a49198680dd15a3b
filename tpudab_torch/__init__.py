"""tpudab_torch — the PyTorch/CUDA port of tpudab: the receive step
(models/step.py), the host per-stage path behind decode-bits
(models/receiver.py), the offline decode of an IQ capture behind decode
(ofdm/sync_device.py, models/pipeline.py, models/step_driver.py,
models/checkpoint.py; host/cli.py), the live radio behind stream
(host/streaming.py, the native ring and IQ reader of host/native_lib.py,
the rtl_tcp source of host/rtl_tcp.py behind stream --tcp, the codecs and
the audio mix of audio/, the dashboard and keys of host/), the demo
capture behind synth (synth/payload.py), the ensemble x time sharded
step on torch.distributed (parallel/, launched by
tools/launch_multihost.py) and the kernel-experiment tools (tools/, run
as python -m tpudab_torch.tools.<name>).

The package mirrors tpudab's layout (audio/, constants/, data/, database/,
fec/, fic/, host/, models/, mot/, msc/, ofdm/, ops/, pad/, parallel/,
synth/, tools/, utils/), so each module's counterpart sits at the same path. It imports
torch and numpy and nothing of jax or of tpudab: what it needs from tpudab
is copied (constants/, the host numpy and C of the live radio) or written
again here without jax, and held equal to its tpudab counterpart by the
tests/test_torch_*.py parity tests.

Every Pallas kernel in tpudab has a hand-written CUDA C++ counterpart
for sm_90a under csrc/, built on first use (ops/_build.py).
Each kernel's wrapper dispatches on the tensor's device alone: a CPU tensor
takes the plain torch version beside it, a CUDA tensor launches the kernel.
"""

__version__ = "0.1.0"

from tpudab_torch.constants.ofdm_params import OFDMParams, get_ofdm_params
from tpudab_torch.constants.dab_params import DABParams, get_dab_params
