"""Faults planted under the timed path, to show that the check catches
them: in the program (portbench/tests, on the CPU) or in the reference put
in the program's place (control.py, on the card at the cell's size).
Each patches the film and path modules of one package while it is open.

- unchanged: each wave's film update returns the film as it was;
- half: the second half of each wave's lanes left out (their filter
  weight zeroed), the film's mean taken over the rest;
- altered: one pixel of each image altered where the film produces it:
  the brightest (the largest mean of its channels; the first in row-major
  order on a tie) doubled, or, where the image is black everywhere, pixel
  [0, 0] set to 1.0, so that the fault always changes the image.
(A cell on one chip has no exchange between chips to leave out.)"""
from __future__ import annotations

import contextlib

import numpy as np

FAULTS = ("unchanged", "half", "altered")


@contextlib.contextmanager
def planted(fault: str, film_mod, path_mod):
    if fault not in FAULTS:
        raise ValueError(f"fault must be one of {FAULTS}")
    saved = [(film_mod, "add_samples", film_mod.add_samples),
             (film_mod, "get_image", film_mod.get_image),
             (path_mod, "render_wave", path_mod.render_wave)]
    get_image, render_wave = film_mod.get_image, path_mod.render_wave

    def unchanged(film, *_a, **_k):
        return film

    def half(*a, **k):
        L, swl, fw = render_wave(*a, **k)
        fw = fw.clone()
        fw[fw.shape[0] // 2:] = 0.0
        return L, swl, fw

    def altered(*a, **k):
        img = get_image(*a, **k).copy()
        if not img.any():
            img[0, 0] = 1.0
            return img
        lum = img.mean(axis=-1)
        img[np.unravel_index(np.argmax(lum), lum.shape)] *= 2.0
        return img

    if fault == "unchanged":
        film_mod.add_samples = unchanged
    elif fault == "half":
        path_mod.render_wave = half
    else:
        film_mod.get_image = altered
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
