"""The BxDFs of the general and volumetric waves as one hand-written kernel
(csrc/bxdf.cu): bxdfs.bsdf_f, bsdf_pdf and bsdf_sample for the diffuse
lobe, the conductor and the dielectric, a thread a lane.

The reference has no such kernel: its BxDFs are XLA tensor code, and the
plain version here is that code in PyTorch (bxdfs.bsdf_f_plain,
bsdf_pdf_plain, bsdf_sample_plain), which counts plain.bxdf. The kernel
gives the plain version's bits on the card, lane for lane (the source's
header says how).

The route is a choice on the scene's static tag set
(BSDFParams.tags_present) and on the tensors' device, made before the
call and never by trying the kernel: `takes` is true for CUDA tensors and
a tag set within KERNEL_TAGS. CPU tensors run the plain version, and so
does any tag set with the hair lobe, whatever the device (its lobe is not
in the kernel).
"""
from __future__ import annotations

import torch

from . import LaunchCounter

DIFFUSE, CONDUCTOR, DIELECTRIC = 0, 1, 2   # bxdfs.BXDF_*, the reference's
KERNEL_TAGS = frozenset((DIFFUSE, CONDUCTOR, DIELECTRIC))

counter = LaunchCounter("bxdf")


def takes(tags_present, device) -> bool:
    """Whether the BxDFs of a scene with this tag set run as the kernel on
    `device`."""
    return (torch.device(device).type == "cuda" and bool(tags_present)
            and set(tags_present) <= KERNEL_TAGS)


def _check(x, name, dtype, shape, align=4):
    if x is None:
        raise ValueError(f"bxdf: {name} is needed by the present tags")
    if x.dtype != dtype or tuple(x.shape) != shape or \
            not x.is_contiguous() or x.data_ptr() % align:
        raise ValueError(f"bxdf: {name} must be a contiguous {dtype} "
                         f"tensor of shape {shape}, {align}-byte aligned; "
                         f"got {x.dtype} {tuple(x.shape)}")
    return x


def _params(p, wo):
    """The lane parameters' pointers, checked against wo's N and device,
    and the kernel's tag arguments (the present tags' bit set; the one
    present tag, or -1)."""
    tags = set(p.tags_present)
    if not tags or not tags <= KERNEL_TAGS:
        raise ValueError(f"bxdf: the kernel takes the tags "
                         f"{sorted(KERNEL_TAGS)}, not {sorted(tags)}")
    n = wo.shape[0]
    _check(wo, "wo", torch.float32, (n, 3))
    spec = bool(tags & {CONDUCTOR, DIELECTRIC})
    ptrs = [_check(p.tag, "tag", torch.int32, (n,)).data_ptr(),
            _check(p.albedo, "albedo", torch.float32, (n, 4), 16).data_ptr()]
    for x, name, shape, align, need in (
            (p.alpha_x, "alpha_x", (n,), 4, spec),
            (p.alpha_y, "alpha_y", (n,), 4, spec),
            (p.eta, "eta", (n, 4), 16, spec),
            (p.k, "k", (n, 4), 16, CONDUCTOR in tags)):
        ptrs.append(_check(x, name, torch.float32, shape, align).data_ptr()
                    if need else 0)
    devices = {t.device for t in (wo, p.tag, p.albedo, p.alpha_x, p.alpha_y,
                                  p.eta, p.k) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"bxdf: tensors on mixed devices {devices}")
    present = sum(1 << t for t in tags)
    single = next(iter(tags)) if len(tags) == 1 else -1
    return ptrs, n, present, single


def eval_args(p, wo, wi):
    """The arguments of bxdf_eval_launch but the stream, checked, and the
    outputs they write: (args, (f (N, 4), pdf (N,)))."""
    ptrs, n, present, single = _params(p, wo)
    _check(wi, "wi", torch.float32, (n, 3))
    if wi.device != wo.device:
        raise ValueError("bxdf: wo and wi on different devices")
    f = torch.empty((n, 4), dtype=torch.float32, device=wo.device)
    pdf = torch.empty((n,), dtype=torch.float32, device=wo.device)
    return (*ptrs, wo.data_ptr(), wi.data_ptr(), f.data_ptr(),
            pdf.data_ptr(), n, present, single), (f, pdf)


def sample_args(p, wo, uc, u2):
    """The arguments of bxdf_sample_launch but the stream, checked, and
    the outputs they write: (args, dict(wi, f, pdf, valid, specular,
    transmission, eta_scale, dispersed)), bsdf_sample's dict. uc is read
    only by the dielectric and may be None without it."""
    ptrs, n, present, single = _params(p, wo)
    uc_ptr = 0
    if DIELECTRIC in p.tags_present:
        uc_ptr = _check(uc, "uc", torch.float32, (n,)).data_ptr()
    _check(u2, "u2", torch.float32, (n, 2), 8)
    if u2.device != wo.device or (uc_ptr and uc.device != wo.device):
        raise ValueError("bxdf: wo, uc and u2 on different devices")

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=wo.device)
    out = dict(wi=empty(n, 3), f=empty(n, 4), pdf=empty(n),
               valid=empty(n, dtype=torch.bool),
               specular=empty(n, dtype=torch.bool),
               transmission=empty(n, dtype=torch.bool), eta_scale=empty(n),
               dispersed=empty(n, dtype=torch.bool))
    return (*ptrs, wo.data_ptr(), uc_ptr, u2.data_ptr(),
            *(out[k].data_ptr() for k in ("wi", "f", "pdf", "valid",
                                          "specular", "transmission",
                                          "eta_scale", "dispersed")),
            n, present, single), out


def _launch(entry: str, args, device):
    import ctypes
    from . import _build
    lib = _build.load_library("bxdf")
    with torch.cuda.device(device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        err = getattr(lib, entry)(*args, stream)
    _build.check(err, entry)
    counter.launches += 1


def f_pdf(p, wo, wi):
    """(f (N, 4), pdf (N,)) of (wo, wi) (N, 3) on the card: bsdf_f's and
    bsdf_pdf's values in one launch."""
    args, out = eval_args(p, wo, wi)
    _launch("bxdf_eval_launch", args, wo.device)
    return out


def sample(p, wo, uc, u2):
    """bsdf_sample's dict for wo (N, 3), uc (N,) or None, u2 (N, 2) on the
    card, in one launch."""
    args, out = sample_args(p, wo, uc, u2)
    _launch("bxdf_sample_launch", args, wo.device)
    return out
