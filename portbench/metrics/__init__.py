"""One reader a metric, metrics/<name>.py, found by the metric's name in
BENCHMARK.json: read(ctx) returns the value, or None where the run holds
nothing to read (the harness then leaves the metric out of the line).

ctx: setup_s (process start to the end of the warm-up), setup (the
set-up's own host-clock parts: kernel_load_s, scene_build_s), window
(harness.Window), trace (tracing.TraceSummary of the traced image, or
None), waves_traced (the traced image's waves), rooflines ({kernel:
roofline.Tally} over the traced image, the window's last). A roofline reader also names its
kernel in ROOFLINE, so that the harness tallies its work."""
