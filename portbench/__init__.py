"""The benchmark of pbrt_tpu_torch on NVIDIA H100s (run.py), driven by
data: BENCHMARK.json at the checkout's root names the cells, metrics and
configurations; configs/, workloads/, metrics/ and roofline/ hold one file
each, found by name; refport/ is the plain reference the outputs are
checked against."""
