"""PyTorch/CUDA port of the `repro` package (FedPM-reg mask training over
frozen random networks, with a <= 1 bit/parameter mask uplink).

The layout mirrors `repro`: `kernels/` (hand-written CUDA kernels for
Hopper beside their plain PyTorch versions), `core/`, `api/`,
`configs/`, `models/`, `data/`, `launch/`.  The port imports torch and
numpy only.  Entry points run on the CUDA card unless the caller asks
for the CPU.
"""
