"""Receiver models: the receive step, the host per-stage Receiver, the
offline pipeline and its checkpoints (counterpart of tpudab.models)."""

from tpudab_torch.models.receiver import Receiver, AudioChannelOutput
from tpudab_torch.models.pipeline import OfflinePipeline, decode_iq
