"""The benchmark of the PyTorch and CUDA port (`unscene3d_torch`): one
command runs one cell of `BENCHMARK.json` once (`python3 -m portbench.run`).
It imports the port only as the system under test; its inputs, weights,
work counts and plain reference are its own."""
