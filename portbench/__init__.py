"""The benchmark of the PyTorch / CUDA port (`cacophony_tpu_torch`).

`python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of BENCHMARK.json once and prints one JSON result line.  A
cell names a configuration (configs/<name>.json, its plain reference
beside it as configs/<name>_ref.py) and a traffic mix (traffic/<mix>.json,
whose "kind" picks the general driver drivers/<kind>.py); a per-layer
metric is a reader metrics/<metric>.py; a cell's correctness limits are
limits/<cell>.json.  Nothing here imports JAX or the JAX package.
"""
