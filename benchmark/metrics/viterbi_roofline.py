"""viterbi_roofline: 100 x the bound of a step's K1+K2 work
(csrc/viterbi.cu::viterbi_kernel: one launch for the FIC and one a coding
group) / the kernel's device time a step in the profiler's trace.

The work of one launch of B codewords on the bf16 (T2p, 8, B) input, T2p
the radix-2 super-steps of the 128-padded mother code: operations B x T2p
x (994 + 4): per super-step and codeword the branch metrics' 98 adds of
the prefix tree, per state 4 adds, 3 compares and 3 selects (ACS) and 4
to pack the decision, and the traceback's select, extract, pack and shift
(the count of chip_smoke.py's FWD_OPS["full"] + TB_OPS); bytes, the input
read once and the decoded bytes written once. The peak is benchmark/peaks.py's."""

from benchmark.peaks import bound_s
from benchmark.trace import kernel_seconds
from benchmark.synth.dab_params import get_dab_params
from benchmark.synth.puncture import FIC_PROFILE, eep_profile, get_uep_profile

OPS_PER_SUPERSTEP = 994 + 4
SOFT_BYTES = 2          # bf16 soft bits


def data_bits(sub: dict) -> int:
    kind, a, b = sub["protection"]
    if kind == "eep":
        return eep_profile(sub["size_cu"], a, b).data_bits
    return get_uep_profile(a, b).to_profile().data_bits


def superstep_count(bits: int) -> int:
    """T2p of a codeword of `bits` data bits: 4 (bits + 6) mother bits
    padded to blocks of 128, 8 to a super-step."""
    return -(-4 * (bits + 6) // 128) * 16


def launches(config: dict, n_ensembles: int, n_frames: int):
    """[(B codewords, T2p, data bits)] of one step's K1+K2 launches: the
    FIC's FIB groups, then each coding group (subchannels of one profile,
    size and padding) over all ensembles and CIFs."""
    dab = get_dab_params(config["mode"])
    fic = FIC_PROFILE.data_bits
    out = [(n_ensembles * n_frames * dab.nb_fib_groups, superstep_count(fic), fic)]
    groups = {}
    for s in config["subchannels"]:
        key = (tuple(s["protection"]), s["size_cu"])
        groups[key] = groups.get(key, 0) + 1
    for (prot, size), n in groups.items():
        bits = data_bits({"protection": prot, "size_cu": size})
        out.append((n * n_ensembles * n_frames * dab.nb_cifs, superstep_count(bits), bits))
    return out


def step_bound_s(config: dict, n_ensembles: int, n_frames: int) -> float:
    return sum(bound_s(b * t2p * 8 * SOFT_BYTES + b * bits // 8, b * t2p * OPS_PER_SUPERSTEP)
               for b, t2p, bits in launches(config, n_ensembles, n_frames))


def read(r):
    s = r.get("trace")
    if not s:
        return None
    sec, n = kernel_seconds(s, "viterbi_kernel")
    if sec <= 0:
        return None
    tr = r["cell"].traffic
    bound = step_bound_s(r["cell"].config, tr["n_ensembles"], tr["n_frames"])
    return 100.0 * bound / (sec / r["steps"])
