"""Dataset viewer — headless PNG tiling + an interactive terminal loop
(the port of tensorforth_tpu/io/vu.py).

The reference ships an OpenGL/GLUT/SDL3 corpus viewer (src/vu/, used by
test binaries only; vu.h gui_init/gui_add/gui_loop).  A server in a
rack has no display, so the equivalents here are (a) tiled PNG files
(same CUDA-texture-tile layout, file-backed) and (b) `vu_loop` — an
interactive ANSI-truecolor viewer that renders samples straight into
the terminal with half-block glyphs (two vertical pixels per text row)
and takes single-key navigation, the moral equivalent of the GLUT
keyboard callback loop (src/vu/gui.cpp).
"""
from __future__ import annotations

import sys

import numpy as np

from .loader import Loader
from ..tb.png import raw2png


def view_corpus(name: str, out_path: str, n: int = 64,
                n_per_row: int = 8) -> str:
    """render the first n corpus samples into a tiled PNG"""
    cp = Loader.get(None, name)
    if cp is None:
        raise FileNotFoundError(name)
    cp.init()
    data, labels = cp.fetch(n)
    cp.rewind()
    h, w, c = cp.H, cp.W, cp.C
    rows = (len(data) + n_per_row - 1) // n_per_row
    px = np.zeros((rows * (h + 1), n_per_row * (w + 1), 3), np.uint8)
    for i, img in enumerate(data):
        r, col = divmod(i, n_per_row)
        img3 = img if c == 3 else np.repeat(img, 3, axis=-1)
        px[r * (h + 1):r * (h + 1) + h,
           col * (w + 1):col * (w + 1) + w] = img3[:, :, :3]
    with open(out_path, "wb") as f:
        f.write(raw2png(px))
    return out_path


def view_tensor(t, out_path: str, n_per_row: int = 8) -> str:
    """render a rank-4 [N,H,W,C] array or torch tensor as a tiled PNG
    (auto-scaled where it lies; only the pixels come to the host)"""
    import torch
    from ..tb.summary import tile_pixels
    d = torch.as_tensor(t)
    px = tile_pixels(d, tuple(d.shape), n_per_row).cpu().numpy()
    with open(out_path, "wb") as f:
        f.write(raw2png(px))
    return out_path


# ===========================================================================
# interactive terminal loop
# ===========================================================================
def render_ansi(img: np.ndarray) -> list[str]:
    """[h,w,c] uint8 -> terminal lines using the ▀ half-block (fg=top
    pixel, bg=bottom pixel: 2 vertical pixels per text row, 24-bit)"""
    img3 = img if img.shape[-1] == 3 else np.repeat(img[..., :1], 3, -1)
    h = img3.shape[0]
    if h % 2:
        img3 = np.concatenate(
            [img3, np.zeros((1,) + img3.shape[1:], np.uint8)], axis=0)
        h += 1
    out = []
    for y in range(0, h, 2):
        top, bot = img3[y], img3[y + 1]
        line = "".join(
            f"\x1b[38;2;{t[0]};{t[1]};{t[2]}m"
            f"\x1b[48;2;{b[0]};{b[1]};{b[2]}m▀"
            for t, b in zip(top, bot))
        out.append(line + "\x1b[0m")
    return out


def _page_lines(data, labels, start: int, per_row: int) -> list[str]:
    """one page: per_row samples side by side + a label caption"""
    tiles, caps = [], []
    for i in range(start, min(start + per_row, len(data))):
        tiles.append(render_ansi(np.asarray(data[i], np.uint8)))
        w = data[i].shape[1]
        caps.append(f"#{i} y={int(labels[i])}".ljust(w + 1)[:w + 1])
    if not tiles:
        return ["(no samples)"]
    rows = max(len(t) for t in tiles)
    lines = []
    for r in range(rows):
        lines.append(" ".join(t[r] if r < len(t) else "" for t in tiles))
    lines.append(" ".join(caps))
    return lines


def _getch(fin):
    """single-key read: raw tty mode when interactive, plain read
    otherwise (lets tests drive the loop from a string buffer)"""
    if fin is sys.stdin and fin.isatty():        # pragma: no cover
        import termios
        import tty
        fd = fin.fileno()
        old = termios.tcgetattr(fd)
        try:
            tty.setraw(fd)
            return fin.read(1)
        finally:
            termios.tcsetattr(fd, termios.TCSADRAIN, old)
    return fin.read(1)


def vu_loop(name: str, fin=None, fout=None, per_row: int = 6) -> int:
    """interactive corpus browser: renders `per_row` samples as ANSI
    half-block tiles; keys: n/p page forward/back, j/k single step,
    r rewind to sample 0, q quit.  Returns the number of pages drawn.
    (reference analog: vu/gui.cpp keyboard loop; here the 'texture' is
    the terminal itself)"""
    fin = fin if fin is not None else sys.stdin
    fout = fout if fout is not None else sys.stdout
    cp = Loader.get(None, name)
    if cp is None:
        raise FileNotFoundError(name)
    cp.init()
    n_show = min(cp.size, 512)                   # browsing window
    data, labels = cp._read(0, n_show)
    pos, pages = 0, 0
    while True:
        fout.write(f"\n== {name} [{pos}..{min(pos + per_row, n_show) - 1}"
                   f" of {cp.size}] n/p page  j/k step  r rewind  q quit ==\n")
        for ln in _page_lines(data, labels, pos, per_row):
            fout.write(ln + "\n")
        fout.flush()
        pages += 1
        c = _getch(fin)
        if not c or c in ("q", "\x03", "\x04"):
            break
        if c == "n":
            pos = min(pos + per_row, max(n_show - per_row, 0))
        elif c == "p":
            pos = max(pos - per_row, 0)
        elif c == "j":
            pos = min(pos + 1, n_show - 1)
        elif c == "k":
            pos = max(pos - 1, 0)
        elif c == "r":
            pos = 0
    return pages
