"""The benchmark of tpudab_torch on one NVIDIA H100: `python3 -m
benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
from the root of a checkout (see run.py). It imports nothing of jax or of
tpudab; of tpudab_torch only the system under test."""
