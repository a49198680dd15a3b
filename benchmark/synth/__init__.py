"""The benchmark's signal source: a frozen copy of tpudab_torch.synth (the
ensemble synthesizer, the OFDM modulator with its channel impairments, the
DAB+ payloads) and of the constants and transmitter-side coding it needs.
It imports nothing of tpudab_torch, so a change to the port's synthesizer
cannot move the benchmark's inputs; benchmark/tests/test_bench_synth.py
pins it to the port's synthesizer as it was when the copy was taken."""
