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

The step's measurement tools (tpudab's tools/profile_step3.py,
exp_step_shapes.py, exp_demod_output.py, exp_conv_demod.py,
exp_aligned_demod.py, exp_viterbi_params.py, exp_viterbi_sweep.py) time
the receive step and its parts on the card, on K5, K4 mode (b) and K1+K2,
the same way (main(argv), run(device, iters, <size>), --device cpu):

    python -m tpudab_torch.tools.profile_step3 [iters]     # the in-step breakdown
    python -m tpudab_torch.tools.exp_step_shapes [iters]   # RTF and memory per (E, F)
    python -m tpudab_torch.tools.exp_demod_output [iters]  # the soft array's concat and norm
    python -m tpudab_torch.tools.exp_conv_demod [iters]    # products on a strided view
    python -m tpudab_torch.tools.exp_aligned_demod [iters] # row-aligned windows
    python -m tpudab_torch.tools.exp_viterbi_params [iters]
    python -m tpudab_torch.tools.exp_viterbi_sweep [iters]

uep_ambiguity reports the UEP table's candidate profiles (host only):

    python -m tpudab_torch.tools.uep_ambiguity [--slack N] [--out PATH]

launch_multihost runs the sharded receive step (tpudab_torch.parallel) in
N processes, as tpudab's tools/launch_multihost.py does:

    python -m tpudab_torch.tools.launch_multihost local --num-processes 2 [--device cpu]
"""
