"""Small utilities: pytree dataclasses, scientific-notation printer, solver table.

JAX counterpart of the reference ``src/utils.jl``.  The in-place
view-add helpers (``add2sub``/``addI2sub``/``sparse_zero!``,
``src/utils.jl:5-31``) have no equivalent here — assembly is functional — so
this module keeps only the user-facing formatting helpers plus the pytree
registration glue every traced container uses.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable

import jax


def pytree_dataclass(cls=None, *, meta_fields: Iterable[str] = ()):
    """Frozen dataclass registered as a JAX pytree.

    Fields named in ``meta_fields`` are static (hashable) auxiliary data;
    everything else is a traced child.
    """
    meta = tuple(meta_fields)

    def wrap(c):
        c = dataclasses.dataclass(frozen=True)(c)
        data = tuple(f.name for f in dataclasses.fields(c) if f.name not in meta)
        jax.tree_util.register_dataclass(c, data_fields=data, meta_fields=meta)
        return c

    return wrap if cls is None else wrap(cls)


def scn(a: float, digits: int = 1) -> str:
    """Scientific-notation string ``" 1.2e-3"`` matching the reference's
    ``scn`` (``src/utils.jl:63-85``)."""
    assert digits >= 0
    a = float(a)
    if a == 0 or not math.isfinite(a):
        e, mant = 0, 0.0 if a == 0 else a
    else:
        e = int(math.floor(math.log10(abs(a))))
        mant = a / (10.0 ** e)
    mant = round(mant, digits)
    if digits == 0:
        s = str(int(math.floor(mant)))
    else:
        s = f"{mant:.{digits}f}"
    sgn = " " if a >= 0 else ""
    sgne = "+" if e >= 0 else ""
    return f"{sgn}{s}e{sgne}{e}"


def display_solver_header() -> None:
    """Console header row (reference ``display_solver_header``, ``src/utils.jl:37-48``)."""
    print(f"{'out':<3} {'in':<2} {'α':<2} {'Δ':<6} {'res':<6} {'reg':<6}")


def display_solver_data(k, l, j, delta, res_norm, reg_x) -> None:
    """Console data row (reference ``display_solver_data``, ``src/utils.jl:50-61``)."""
    print(f"{k:<3} {l:<2} {j:<2} {float(delta):<6.0e} "
          f"{float(res_norm):<6.0e} {float(reg_x):<6.0e}")


def convert_video_to_gif(video_path: str, gif_path: str,
                         framerate: int = 30, width: int = 1080,
                         overwrite: bool = True) -> None:
    """Convert a screen-capture video to a gif by shelling out to ffmpeg
    (counterpart of the reference's ``convert_video_to_gif``,
    ``src/utils.jl:91-120``, which calls ``FFMPEG.exe``).

    Requires an ``ffmpeg`` binary on PATH; raises ``FileNotFoundError``
    otherwise (the reference similarly depends on an external FFMPEG it does
    not declare as a dependency).
    """
    import shutil
    import subprocess

    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        raise FileNotFoundError("ffmpeg not found on PATH")
    cmd = [ffmpeg, "-i", video_path,
           "-vf", f"fps={framerate},scale={width}:-1:flags=lanczos",
           gif_path]
    if overwrite:
        cmd.insert(1, "-y")
    subprocess.run(cmd, check=True, capture_output=True)
