"""The kernel-experiment tools of tpudab (tools/exp_*.py) on the card, one
module per tool with the tool's name:

    python -m tpudab_torch.tools.exp_viterbi_decompose [iters]   # X2
    python -m tpudab_torch.tools.exp_viterbi [iters]             # X1
    python -m tpudab_torch.tools.exp_viterbi_i16 [iters]         # X3
    python -m tpudab_torch.tools.exp_tb_tree [iters]             # X5
    python -m tpudab_torch.tools.exp_depunct_t [iters]           # X6
    python -m tpudab_torch.tools.exp_i16_probe                   # X4
    python -m tpudab_torch.tools.exp_carve [iters]               # X7

Each runs what tpudab's main() runs, at the same shapes and seeds, with its
kernels in csrc/viterbi.cu, csrc/i16_probe.cu and csrc/carve.cu (K5's), and
prints its times, taken with CUDA events, beside the card's name and power
limit. --device cpu runs the plain torch twins, with host times. Each
module's run(device, iters, ...) does main's work at a size it is given,
which is how a run is rehearsed small on the CPU.

launch_multihost runs the sharded receive step (tpudab_torch.parallel) in
N processes, as tpudab's tools/launch_multihost.py does:

    python -m tpudab_torch.tools.launch_multihost local --num-processes 2 [--device cpu]
"""
