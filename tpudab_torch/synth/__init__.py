"""DAB signal synthesizer without jax (counterpart of tpudab.synth)."""

from tpudab_torch.synth.modulator import modulate_frame_bits, Impairments, apply_impairments
from tpudab_torch.synth.ensemble import (
    EnsembleSpec, ServiceSpec, SubchannelSpec, EnsembleSynthesizer,
    ASCTY_DAB, ASCTY_DAB_PLUS, TMID_STREAM_AUDIO, TMID_PACKET_DATA,
)
