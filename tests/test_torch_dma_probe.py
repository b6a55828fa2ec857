"""Port vs reference: the page-copy probes.

Each of the 14 configurations of the TPU tools (tools/exp_dma_var.py: six
VARs; tools/exp_dma_var2.py: four VARs; tools/exp_dma_min.py: STAGE 1..4)
is run as the tool itself, unedited, with `pallas_call` in interpret mode,
and the numbers it prints are held to the port's plain version on the same
numpy inputs exactly (integers in float32; tolerance 0). On the CPU a
wrapper of ops/dma_probe.py runs its plain version; the kernels run on
the card (tests/test_torch_cuda.py).
"""
import functools
import os
import re
import runpy
import subprocess
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from pbrt_tpu_torch.ops import dma_probe as dp  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import torch_dma_probe as tool  # noqa: E402

TPU_TOOL = {"var": "exp_dma_var.py", "var2": "exp_dma_var2.py",
            "min": "exp_dma_min.py"}
CONFIGS = tool.configurations()


def _floats(text):
    return [float(x) for x in re.findall(r"-?\d+\.?\d*(?:e[+-]?\d+)?", text)]


def _run_tpu_tool(probe, which, monkeypatch, capsys):
    """The TPU tool's printed result: (values, its own verdict line)."""
    monkeypatch.setenv("STAGE" if probe == "min" else "VAR", str(which))
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    capsys.readouterr()
    runpy.run_path(str(ROOT / "tools" / TPU_TOOL[probe]),
                   run_name="__main__")
    out = capsys.readouterr().out
    assert "WRONG" not in out and "OK" in out, out
    if probe == "var":
        line = re.search(r"value: (\S+) expected: (\S+)", out)
        return [float(line.group(1))]
    if probe == "var2":
        return _floats(re.search(r"got: \[(.*?)\]", out, re.S).group(1))
    return _floats(re.search(r"result row means: \[(.*?)\]", out,
                             re.S).group(1))


@pytest.mark.parametrize("probe, which", CONFIGS,
                         ids=[f"{p}-{w}" for p, w in CONFIGS])
def test_plain_version_equals_the_tpu_tool(probe, which, monkeypatch,
                                           capsys):
    want = np.asarray(_run_tpu_tool(probe, which, monkeypatch, capsys),
                      np.float32)
    before = [c.plain for c in (dp.counter_var, dp.counter_pipelined,
                                dp.counter_manual, dp.counter_ladder)]
    out, got, exp = tool.run_probe(probe, which, device="cpu")
    after = [c.plain for c in (dp.counter_var, dp.counter_pipelined,
                               dp.counter_manual, dp.counter_ladder)]
    assert sum(after) - sum(before) == 1   # the wrapper took the plain way
    # every element of a block's tile holds the block's number
    assert (got == got[:, :1]).all()
    per_block = got.mean(axis=1) if probe == "min" else got[:, 0]
    np.testing.assert_array_equal(per_block, want)
    np.testing.assert_array_equal(per_block, exp)
    assert out.dtype == torch.float32
    assert out.shape == ((8, 128) if probe == "var" else (32, 128))


def test_the_14_configurations():
    assert len(CONFIGS) == 14
    assert [w for p, w in CONFIGS if p == "min"] == [1, 2, 3, 4]


def _inputs(R, K=12, B=5, P=3, fill="small", seed=1):
    pages = dp.make_pages(K, R, "cpu", fill=fill)
    x = torch.as_tensor(np.random.default_rng(seed).integers(
        0, 9, (B * 8, 128)).astype(np.float32))
    return pages, x, dp.probe_schedule("seeded", B, P, K, "cpu", seed=seed)


@pytest.mark.parametrize("a, b", [("hbm_smem_slice", "hbm_vmem_slice"),
                                  ("hbm_smem_full", "hbm_vmem_full"),
                                  ("vmem_smem", "smem_1d")])
def test_smem_and_vmem_names_share_a_result(a, b):
    pages, x, _s = _inputs(16)
    outs = [dp.dma_var(pages.view(12, -1) if v == "smem_1d" else pages,
                       x[:8], v, copy=c, reduce="sum")
            for v in (a, b) for c in dp.COPIES]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    for mode in dp.MODES:
        got = dp.dma_sched(pages, x, _s, 3, mode=mode, reduce="sum")
        assert torch.equal(got, dp.dma_sched_plain(pages, x, _s, 3, "sum"))


@pytest.mark.parametrize("R, mode", [(226, "pipelined"), (298, "manual"),
                                     (378, "manual")])
def test_whole_page_sums_are_exact(R, mode):
    """reduce="sum" at the paged kernels' page sizes against a float64
    numpy sum: small-integer pages keep every float32 sum exact."""
    pages, x, sched = _inputs(R)
    got = dp.dma_sched(pages, x, sched, 3, mode=mode, reduce="sum").numpy()
    page_sum = pages.numpy().astype(np.float64).sum(axis=(1, 2))
    want = x.numpy() + np.repeat(
        page_sum[sched.numpy().reshape(-1, 3)].sum(axis=1), 8)[:, None]
    assert want.max() < 2 ** 24 and page_sum.min() > 0
    np.testing.assert_array_equal(got, want.astype(np.float32))
    lad = dp.probe_schedule("min", 5, 3, 12, "cpu")
    got = dp.dma_ladder(pages, x, lad, 3, 4, reduce="sum").numpy()
    s = lad.numpy().reshape(-1, 3)
    want = x.numpy() + np.repeat(np.where(
        s >= 0, page_sum[np.maximum(s, 0)], 0.0).sum(axis=1), 8)[:, None]
    np.testing.assert_array_equal(got, want.astype(np.float32))


def test_schedules_are_the_tpu_tools():
    assert dp.probe_schedule("var2", 4, 2, 8, "cpu").tolist() == \
        [1, 3, 2, 4, 3, 5, 4, 6]
    assert dp.probe_schedule("min", 4, 2, 8, "cpu").tolist() == \
        [0, 1, 1, -1, 2, 3, 3, -1]
    np.testing.assert_array_equal(
        dp.make_pages(8, 16, "cpu").numpy().reshape(-1),
        np.arange(8 * 16 * 128, dtype=np.float32))


def test_ordered_schedule_ascends_without_repeats():
    s = dp.probe_schedule("ordered", 16, 20, 420, "cpu", seed=3).numpy() \
        .reshape(16, 20)
    assert s.min() >= 0 and s.max() < 420 and (np.diff(s, axis=1) > 0).all()
    assert len({tuple(r) for r in s}) == 16
    with pytest.raises(ValueError, match="without repeats"):
        dp.probe_schedule("ordered", 2, 9, 8, "cpu")
    assert [c[4] for c in tool.matrix_cases()].count("ordered") == 2


def test_run_plain_is_the_plain_version_on_the_probes_inputs():
    for probe, which in CONFIGS:
        out, _got, _exp = tool.run_probe(probe, which, device="cpu")
        assert torch.equal(tool.run_plain(probe, which, device="cpu"), out)


@pytest.mark.parametrize("call, match", [
    # two buffers of 227 rows are 232,448 B: over, with the static 256 B
    (lambda p, x, s: dp.dma_sched(dp.make_pages(4, 227, "cpu"), x, s, 3),
     "2 buffer\\(s\\) of 227 rows x 512 B = 232448 B.*232448 B of shared"),
    (lambda p, x, s: dp.dma_var(dp.make_pages(4, 227, "cpu"), x[:8],
                                "vmem_smem"), "2 buffer"),
    (lambda p, x, s: dp.dma_sched(dp.make_pages(4, 454, "cpu"), x, s, 3,
                                  mode="manual"),
     "1 buffer\\(s\\) of 454 rows"),
    (lambda p, x, s: dp.dma_var(dp.make_pages(60, 16, "cpu"), x[:8],
                                "hbm_vmem_full"), "60 buffer"),
    (lambda p, x, s: dp.dma_var(p, x[:8], "hbm_tmem_slice"),
     "unknown variant"),
    (lambda p, x, s: dp.dma_ladder(p, x, s, 3, 5), "unknown stage"),
    (lambda p, x, s: dp.dma_sched(p, x, s, 3, copy="tma"),
     "unknown copy path"),
    (lambda p, x, s: dp.dma_sched(p, x, s, 3, mode="auto"), "unknown mode"),
    (lambda p, x, s: dp.dma_ladder(p, x, s, 3, 1, reduce="max"),
     "unknown reduce"),
    (lambda p, x, s: dp.dma_sched(p, x[:8], s, 3), "x must be \\(40, 128\\)"),
    (lambda p, x, s: dp.dma_sched(p, x, s.long(), 3), "int32"),
    (lambda p, x, s: dp.make_pages(420, 378, "cpu"), "not\\s+exact"),
], ids=["two-buffers", "two-hop", "one-page", "all-pages", "variant",
        "stage", "copy", "mode", "reduce", "x-shape", "sched-dtype",
        "arange"])
def test_refusals(call, match):
    pages, x, sched = _inputs(16)
    with pytest.raises(ValueError, match=match):
        call(pages, x, sched)


def test_largest_pages_are_taken():
    """226 rows twice and 453 rows once fit with the static 256 B."""
    _p, x, sched = _inputs(16)
    dp.dma_sched(dp.make_pages(4, 226, "cpu", "small"), x,
                 sched.clamp(max=3), 3)
    dp.dma_sched(dp.make_pages(4, 453, "cpu", "small"), x,
                 sched.clamp(max=3), 3, mode="manual")


def test_device_defaults_to_the_card():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="cuda"):
        dp.make_pages(8, 16)
    with pytest.raises(RuntimeError, match="cuda"):
        dp.probe_schedule("var2", 4, 2, 8)
    with pytest.raises(RuntimeError, match="cuda"):
        tool.run_probe("var", "hbm_vmem_slice")
    with pytest.raises(RuntimeError, match="needs the card"):
        tool.run_matrix("cpu")


@pytest.mark.parametrize("args, lines", [
    (["--probe", "var", "--variant", "smem_1d"],
     ["value: 4096.0 expected: 4096.0 OK"]),
    (["--probe", "var2", "--variant", "ds_vmem", "--copy", "bulk"],
     ["got: [ 8192. 12288. 16384. 20480.] exp: [ 8192. 12288. 16384. 20480.]"
      " OK"]),
    (["--probe", "min", "--stage", "3"],
     ["result row means: [ 2048.  2048. 10240.  6144.]", "OK"]),
    (["--probe", "min", "--stage", "2", "--rows", "298", "--reduce", "sum"],
     ["OK"]),
], ids=["var", "var2", "min", "min-298-rows"])
def test_tool_prints_the_tpu_tools_lines(args, lines):
    """tools/torch_dma_probe.py in a process of its own, on the CPU."""
    r = subprocess.run([sys.executable, str(ROOT / "tools" /
                                            "torch_dma_probe.py"),
                        "--device", "cpu", *args], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    out = r.stdout.splitlines()
    assert out[0].startswith("device: cpu")
    for line in lines:
        assert line in out, r.stdout


def test_tool_defaults_to_the_card():
    r = subprocess.run([sys.executable, str(ROOT / "tools" /
                                            "torch_dma_probe.py")],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and "torch.cuda.is_available() is False" in \
        r.stderr
