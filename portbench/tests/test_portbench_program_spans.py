"""The readers of the program's own spans on synthetic image records: the
window's records lined up from the end, the traced image dropped, the
warm-up found by its sequence number, None where the records do not line
up or the program keeps none; and on the records of a real render on the
CPU."""
import types

import pytest

from portbench import program_spans
from portbench.metrics import (bsdf_ms_per_wave, film_readout_s,
                               sampler_ms_per_wave, warmup_render_s)

W, H, SPP = 20, 10, 8


def record(seq, get_image_ns, spp=SPP, waves=2, draw_ns=None, bsdf=None,
           start=0):
    spans = {"render.image": dict(calls=1, ns=10 ** 9, self_ns=0),
             "film.get_image": dict(calls=1, ns=get_image_ns,
                                    self_ns=get_image_ns)}
    if draw_ns is not None:
        spans["sampler.draw"] = dict(calls=10, ns=draw_ns, self_ns=draw_ns)
    if bsdf is not None:
        spans["bsdf.eval"] = dict(calls=4, ns=bsdf[0], self_ns=bsdf[0])
        spans["bsdf.sample"] = dict(calls=2, ns=bsdf[1], self_ns=bsdf[1])
    return dict(seq=seq, spp=spp, width=W, height=H, lanes_per_wave=W * H,
                waves=waves, anchor=(0, 0), start_ns=start,
                end_ns=start + 3 * 10 ** 9, spans=spans, counters={})


def ctx_of(n_images, traced=True):
    window = types.SimpleNamespace(images=[None] * n_images,
                                   paths=n_images * W * H * SPP)
    return types.SimpleNamespace(window=window,
                                 trace=object() if traced else None)


def recs():
    """The warm-up (one wave's spp), an image of an earlier run of
    another size, then a window of four images, the last traced."""
    return [record(0, 1, spp=1, waves=1, start=5),
            record(1, 7, spp=2),
            record(2, 100, draw_ns=8e6, bsdf=(10e6, 2e6)),
            record(3, 300, draw_ns=4e6, bsdf=(20e6, 4e6)),
            record(4, 200, draw_ns=6e6, bsdf=(30e6, 6e6)),
            record(5, 10 ** 6, draw_ns=1e9, bsdf=(1e9, 1e9))]


def test_window_lines_up_from_the_end_and_drops_the_traced_image():
    win = program_spans.window(ctx_of(4), recs())
    assert [r["seq"] for r in win] == [2, 3, 4]
    # an untraced run keeps its last image
    assert [r["seq"] for r in program_spans.window(
        ctx_of(4, traced=False), recs())] == [2, 3, 4, 5]


def test_medians_of_the_untraced_images(monkeypatch):
    monkeypatch.setattr(program_spans, "records", recs)
    ctx = ctx_of(4)
    assert film_readout_s.read(ctx) == pytest.approx(200e-9)
    # per wave (2 a record): draws 4, 2, 3 ms; BxDFs 6, 12, 18 ms
    assert sampler_ms_per_wave.read(ctx) == pytest.approx(3.0)
    assert bsdf_ms_per_wave.read(ctx) == pytest.approx(12.0)
    assert warmup_render_s.read(ctx) == pytest.approx(3.0)


@pytest.mark.parametrize("n_images", [5, 7])
def test_none_where_the_records_do_not_line_up(monkeypatch, n_images):
    """Five: the window would reach the record of another size; seven:
    more images than records."""
    monkeypatch.setattr(program_spans, "records", recs)
    ctx = ctx_of(n_images)
    for reader in (film_readout_s, warmup_render_s, sampler_ms_per_wave,
                   bsdf_ms_per_wave):
        assert reader.read(ctx) is None


def test_none_without_records_or_spans(monkeypatch):
    monkeypatch.setattr(program_spans, "records", lambda: None)
    assert film_readout_s.read(ctx_of(4)) is None
    assert warmup_render_s.read(ctx_of(4)) is None
    # the megakernel's images hold no general-wave stage
    monkeypatch.setattr(program_spans, "records", lambda: [
        record(0, 1, spp=1), record(1, 5), record(2, 6)])
    assert sampler_ms_per_wave.read(ctx_of(2)) is None
    assert film_readout_s.read(ctx_of(2)) == pytest.approx(5e-9)
    # no warm-up record: nothing to read
    monkeypatch.setattr(program_spans, "records", lambda: [
        record(3, 5), record(4, 6)])
    assert warmup_render_s.read(ctx_of(2)) is None


def test_records_of_a_render_on_the_cpu():
    """The program's records as the harness leaves them: a render's
    record lines up, and film.get_image is read from it."""
    from pbrt_tpu_torch import scenes, spans
    from pbrt_tpu_torch.integrators import render
    scene, cam = scenes.make_cornell_box(W, H, device="cpu")
    for _ in range(2):
        render.render(scene, cam, spp=SPP, device="cpu")
    assert spans.images()[-1]["spp"] == SPP
    ctx = ctx_of(2)
    assert len(program_spans.window(ctx)) == 1
    assert film_readout_s.read(ctx) > 0
    assert warmup_render_s.read(ctx) > 0
