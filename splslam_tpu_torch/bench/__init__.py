"""The port's benches (`bench_torch.py` at the repository root runs
them): `stereo` (bench.py), `mapping` (bench_mapping.py), `mono`
(bench_mono.py) and `components` (bench_components.py), over the
protocol in `common`. Each bench's `run(Bench, size)` returns its JSON
rows; `size` is the bench's `FULL` configuration or its `SMALL` CPU
test size."""
