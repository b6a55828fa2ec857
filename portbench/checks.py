"""Whether what the timed path rendered is right. An image that the
program rendered in the window is held to two witnesses, once the window
has closed:

- the plain reference (portbench/refport, a frozen copy of the program's
  plain PyTorch versions), rendered from the same scene text with the same
  sampler seed: both sides draw the same samples, so the images agree up
  to the lanes whose hit or roulette decisions a rounding-level difference
  flips (image_mrse, mean_ratio_err, worst_pixel_err). It catches a kernel
  or a later change that departs from the plain code;
- pbrt-v4's own render of the same scene at the same resolution and spp
  (the cell's `golden`, an OpenEXR file made by the C++ renderer, not by
  this code): two independent Monte Carlo estimates, compared by
  tools/golden.py's relative MSE with its trim (golden_mrse). It catches
  what the program and its frozen copy share.

Where the image is larger than the reference can render inside a
window's length, the reference renders a sample of its rows drawn from the
seed (the workload's `reference_rows`): the pixels are independent (each
sample lands in its own pixel), so those rows are its answers for them.
Where pbrt-v4's render shows a part of a larger film (`golden_window`: the
central square of a wide film, whose camera spans the same view on its
shorter axis), that part is area-averaged to the golden's size first.

Each number compared has its limit in the cell's workload file
(`limits`), set from sound runs and from the control (BF16, below)."""
from __future__ import annotations

import numpy as np
import torch
from torch.overrides import TorchFunctionMode


def mrse(img, ref) -> float:
    """Relative mean squared error, as tools/golden.py's mrse (trim 0)."""
    d = img.astype(np.float64) - ref
    return float((d * d / (ref.astype(np.float64) ** 2 + 0.01)).mean())


def mean_ratio_err(img, ref) -> float:
    """|mean(img) / mean(ref) - 1|: a bias of the whole image."""
    return abs(float(img.astype(np.float64).mean())
               / max(float(ref.astype(np.float64).mean()), 1e-12) - 1.0)


def worst_pixel_err(img, ref) -> float:
    """The largest relative error of one pixel: max over pixels of
    |img - ref| / (|ref| + 0.01), its channels averaged."""
    d = np.abs(img.astype(np.float64) - ref) / (np.abs(ref) + 0.01)
    return float(d.mean(axis=-1).max())


def golden_mrse(img, golden, trim: float = 0.0) -> float:
    """tools/golden.py's mrse against pbrt-v4's render: each pixel's
    relative squared error, its channels averaged; the `trim` share of the
    largest dropped (specular fireflies land in different pixels of two
    independent renders at this spp); the mean of the rest."""
    d = img.astype(np.float64) - golden
    e = (d * d / (golden.astype(np.float64) ** 2 + 0.01)).mean(axis=-1)
    e = e.reshape(-1)
    if trim > 0:
        e = np.sort(e)[:max(1, int(len(e) * (1.0 - trim)))]
    return float(e.mean())


# against the plain reference, by name
REFERENCE_NUMBERS = {"image_mrse": mrse, "mean_ratio_err": mean_ratio_err,
                     "worst_pixel_err": worst_pixel_err}
NUMBERS = (*REFERENCE_NUMBERS, "golden_mrse")


def read_golden(path) -> np.ndarray:
    """pbrt-v4's render, (H, W, 3) float32 linear RGB."""
    from portbench.refport.utils import image
    return image.read_exr(path)


def resample(img, window, shape) -> np.ndarray:
    """The part window = (x0, y0, x1, y1) of img, (H, W, 3), area-averaged
    to shape (h, w): each output pixel the mean of the film it covers, a
    partly covered pixel weighed by the part."""
    x0, y0, x1, y1 = window
    part = np.asarray(img, np.float64)[y0:y1, x0:x1]
    wy = _area_weights(shape[0], y1 - y0)
    wx = _area_weights(shape[1], x1 - x0)
    rows = np.tensordot(wy, part, axes=(1, 0))            # (h, x, 3)
    return np.tensordot(rows, wx, axes=(1, 1)).transpose(0, 2, 1)


def _area_weights(n_out: int, n_in: int) -> np.ndarray:
    """(n_out, n_in): the share of input pixel j in output pixel i."""
    f = n_in / n_out
    edges = f * np.arange(n_out + 1)
    j = np.arange(n_in)
    lo = np.maximum(edges[:-1, None], j[None, :])
    hi = np.minimum(edges[1:, None], j[None, :] + 1)
    return np.clip(hi - lo, 0.0, None) / f


def compare(img, ref, golden=None, trim: float = 0.0, rows=None,
            window=None) -> dict:
    """Every number compared, by name: the image `img` against the
    reference's rendering `ref` of its `rows` (all where None) and, where a
    golden is given, its `window` (all where None) against the golden; inf
    where the image is not finite or a shape does not match."""
    names = list(REFERENCE_NUMBERS) + (["golden_mrse"]
                                       if golden is not None else [])
    part = img if rows is None else img[rows]
    if part.shape != ref.shape or not np.isfinite(img).all():
        return {k: float("inf") for k in names}
    view = img
    if golden is not None and window is not None:
        if img.shape[0] < window[3] or img.shape[1] < window[2]:
            return {k: float("inf") for k in names}
        view = resample(img, window, golden.shape[:2])
    if golden is not None and view.shape != golden.shape:
        return {k: float("inf") for k in names}
    out = {k: fn(part, ref) for k, fn in REFERENCE_NUMBERS.items()}
    if golden is not None:
        out["golden_mrse"] = golden_mrse(view, golden, trim)
    return out


def within(numbers: dict, limits: dict) -> bool:
    return all(numbers[k] <= limits[k] for k in limits)


def image_seed(seed: int, index: int) -> int:
    """The sampler seed of image `index` of a run (index -1: the warm-up),
    a 31-bit value drawn from the run's seed."""
    ss = np.random.SeedSequence([seed % (1 << 64), index + 1])
    return int(ss.generate_state(1, np.uint32)[0] >> 1)


def sample_rows(seed: int, index: int, height: int, n: int = None):
    """The rows of image `index` that the reference renders: one drawn
    from the seed in each of n equal bands of the image, in order; None
    (every row) where n is None or not below the height."""
    if n is None or n >= height:
        return None
    rng = np.random.default_rng([seed % (1 << 64), index + 1, 0x0805])
    edges = (np.arange(n + 1) * height) // n
    return edges[:-1] + (rng.random(n) * np.diff(edges)).astype(np.int64)


def sample_index(seed: int, n_images: int) -> int:
    """The image of the window that is compared, drawn from the seed."""
    return int(np.random.default_rng([seed % (1 << 64), 0x5EED])
               .integers(n_images))


class Reference:
    """The plain reference on `device`: parses the scene text once, then
    renders any image of the run from its sampler seed."""

    def __init__(self, text: str, base_dir, wl, device):
        from portbench.refport.scene import parser
        self.wl, self.device = wl, device
        self.desc = parser.parse_string(text, base_dir=str(base_dir),
                                        device=device)

    def render(self, seed: int, rows=None, cols=None) -> np.ndarray:
        """The image of sampler seed `seed`, (H, W, 3); or only its pixels
        in `rows` (row numbers) and `cols` (a range of columns), (rows,
        cols, 3)."""
        from portbench.refport import samplers
        from portbench.refport.integrators import path, render
        wl = self.wl
        sampler = samplers.make_sampler("zsobol", wl.spp, seed,
                                        full_resolution=(wl.width,
                                                         wl.height))
        opts = path.PathOptions(max_depth=wl.max_depth,
                                megakernel=wl.megakernel)
        if rows is None and cols is None:
            img, _stats = render.render(
                self.desc.scene, self.desc.camera, wl.spp,
                device=self.device, sampler=sampler, opts=opts)
            return img
        rows = np.arange(wl.height) if rows is None else np.asarray(rows)
        cols = range(wl.width) if cols is None else cols
        return self._render_pixels(sampler, opts, rows, cols)

    def _render_pixels(self, sampler, opts, rows, cols) -> np.ndarray:
        """render.render's loop over the pixels rows x cols alone: the same
        sample indices a lane, waves of as many sample indices as the whole
        image's waves hold, each pixel's samples summed in the same order
        (film.add_samples' identity path, on a film of these pixels)."""
        from portbench.refport import film as film_mod
        from portbench.refport import filters
        from portbench.refport.integrators import path, render
        wl, dev, scene = self.wl, self.device, self.desc.scene
        pix = (torch.as_tensor(rows, dtype=torch.int64)[:, None] * wl.width
               + torch.arange(cols.start, cols.stop, dtype=torch.int64)
               [None, :]).reshape(-1).to(dev)
        n, n_pix, m = pix.numel(), wl.width * wl.height, 1
        while m * 2 * n_pix <= render.MAX_WAVE_LANES and \
                wl.spp % (m * 2) == 0:
            m *= 2
        pixel_idx = pix.repeat(m)
        lane_s = torch.arange(n * m, dtype=torch.int64, device=dev) // n
        sensor = film_mod.make_pixel_sensor()
        filt = filters.make_filter("gaussian")
        film = film_mod.make_film(n, 1, dev)
        for s in range(0, wl.spp, m):
            L, swl, fw = render.wave_module(scene).render_wave(
                scene, self.desc.camera, sampler, filt, pixel_idx,
                s + lane_s, opts)
            rgb = film_mod.sensor_to_sensor_rgb(sensor, L, swl)
            film_mod.add_samples(film, pixel_idx, rgb, fw, identity=True)
        return film_mod.get_image(film, sensor).reshape(
            len(rows), len(cols), 3)


def _aliases(out, args):
    ptr = out.untyped_storage().data_ptr()
    return any(isinstance(a, torch.Tensor)
               and a.untyped_storage().data_ptr() == ptr for a in args)


def _inplace(func) -> bool:
    name = getattr(func, "__name__", "")
    return (name.endswith("_") and not name.endswith("__")) or \
        name.startswith("__i")


def to_bf16(x: torch.Tensor) -> torch.Tensor:
    """float32 values cut to bfloat16's 8 significant bits, toward zero, so
    that a value in [0, 1) stays below 1, as the program's index arithmetic
    (u x size) assumes of its samples."""
    return (x.view(torch.int32) & -65536).view(torch.float32)


class BF16(TorchFunctionMode):
    """The control: every float32 tensor that a torch call makes, cut to
    bfloat16 (to_bf16), the precision below the configuration's float32
    (the renderer runs no matrix product, so TF32 does not apply). Views
    keep aliasing their base; an in-place result is cut in place."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        return self._round(out, func, args)

    def _round(self, out, func, args):
        if isinstance(out, (tuple, list)):
            if not any(isinstance(o, torch.Tensor) for o in out):
                return out          # torch.Size and the like
            items = [self._round(o, func, args) for o in out]
            if type(out) in (tuple, list):
                return type(out)(items)
            return type(out)(items) if hasattr(out, "n_fields") \
                else type(out)(*items)   # torch.return_types, namedtuples
        if not isinstance(out, torch.Tensor) or out.dtype != torch.float32:
            return out
        if _aliases(out, args):
            if _inplace(func) and out.is_contiguous():
                out.copy_(to_bf16(out))
            return out
        return to_bf16(out.contiguous())
