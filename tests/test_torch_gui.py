"""The port's corpus viewers (tensorforth_tpu_torch/io/gui.py and io/vu.py)
and `--vu` on the CPU, against the JAX package's: test_gui.py's cases with
a fake display, the raw xcb binding against test_gui_x11.py's fake X
server, and test_multitask.py's viewer cases.
"""
import io
import os
import sys

import numpy as np
import pytest

from tensorforth_tpu_torch.io import gui
from tensorforth_tpu_torch.io.loader import Loader
from tests.test_gui import FakeDisplay
from tests.test_torch_threads import one_torch_thread  # noqa: F401


def _corpus():
    cp = Loader.get(None, "mnist_test")
    assert cp is not None
    return cp


def test_gui_init_headless_returns_false(monkeypatch):
    monkeypatch.delenv("DISPLAY", raising=False)
    assert gui.gui_init() is False


def test_corpus_vu_paging_bounds():
    vu = gui.CorpusVu(_corpus(), per_row=4)
    assert vu.pos == 0
    assert vu.keyboard("k") is False            # clamped at 0
    assert vu.keyboard("n") is True and vu.pos == 4
    assert vu.keyboard("j") is True and vu.pos == 5
    assert vu.keyboard("r") is True and vu.pos == 0
    vu.keyboard("q")
    assert vu.done
    vu2 = gui.CorpusVu(_corpus(), per_row=4)
    for _ in range(10_000):
        vu2.keyboard("n")
    assert vu2.pos == vu2.n_show - 4


def test_corpus_vu_pixels_match_jax():
    """the pages the port draws are the JAX package's, byte for byte"""
    from tensorforth_tpu.io import gui as jgui
    from tensorforth_tpu.io.loader import Loader as JLoader
    vu = gui.CorpusVu(_corpus(), per_row=3)
    jvu = jgui.CorpusVu(JLoader.get(None, "mnist_test"), per_row=3)
    for key in ("", "n", "j", "n"):
        if key:
            vu.keyboard(key)
            jvu.keyboard(key)
        px = vu.pixels()
        assert px.shape == (vu.height(), vu.width(), 3)
        assert px.dtype == np.uint8 and px.max() > 0
        np.testing.assert_array_equal(px, jvu.pixels())
    assert vu.width() % 3 == 0 and (vu.width() // 3 - 2) % vu.corpus.W == 0


def test_gui_loop_expose_key_quit():
    fake = FakeDisplay([("expose", None), ("key", "n"), (None, None),
                        ("key", "x"), ("key", "q"), ("expose", None)])
    assert gui.gui_init(display=fake) is True
    win = gui.gui_add(gui.CorpusVu(_corpus(), per_row=2))
    assert gui.gui_loop() == 2
    assert fake.blits[0][0] == win
    assert fake.closed
    assert len(fake.events) == 1                 # post-quit event unread


def test_corpus_vu_mouse():
    vu = gui.CorpusVu(_corpus(), per_row=4)
    assert vu.mouse(1, 10, 10) is True and vu.pos == 4    # left: page fwd
    assert vu.mouse(3, 10, 10) is True and vu.pos == 0    # right: back
    assert vu.mouse(5, 0, 0) is True and vu.pos == 1      # wheel down
    assert vu.mouse(4, 0, 0) is True and vu.pos == 0      # wheel up
    assert vu.mouse(2, 0, 0) is False                     # middle: no-op


def test_gui_loop_button_event():
    fake = FakeDisplay([("expose", None), ("button", (1, 5, 5)),
                        ("key", "q")])
    gui.gui_init(display=fake)
    vu = gui.CorpusVu(_corpus(), per_row=2)
    gui.gui_add(vu)
    assert gui.gui_loop() == 2
    assert vu.pos == 2


def test_gui_loop_close_event():
    fake = FakeDisplay([("expose", None), ("close", None)])
    gui.gui_init(display=fake)
    gui.gui_add(gui.CorpusVu(_corpus(), per_row=2))
    assert gui.gui_loop() == 1
    assert fake.closed


def test_vu_window_headless_falls_back(monkeypatch):
    monkeypatch.delenv("DISPLAY", raising=False)
    assert gui.vu_window("mnist_test") == -1


def test_xcb_binding_against_fake_server(monkeypatch):
    """the port's raw libxcb binding drives test_gui_x11.py's fake X
    server: connection setup, keyboard map, window, GC, chunked PutImage
    and the event loop"""
    import tests.test_gui_x11 as x11
    if not x11.HAVE_XCB:
        pytest.skip("libxcb absent")
    display_no = 7500 + os.getpid() % 500        # not the JAX test's
    srv = x11.FakeXServer(display_no)
    srv.start()
    monkeypatch.setenv("DISPLAY", f":{display_no}")
    monkeypatch.delenv("XAUTHORITY", raising=False)
    assert gui.gui_init() is True, "binding failed to connect"
    vu = gui.CorpusVu(_corpus(), per_row=2)
    gui.gui_add(vu)
    frames = gui.gui_loop()
    srv.join(timeout=20)
    assert srv.error is None, srv.error
    assert frames == 3, (frames, srv.opcodes)
    assert vu.pos == 0
    for op in (x11._OP_GET_KEYBOARD_MAPPING, x11._OP_CREATE_WINDOW,
               x11._OP_CHANGE_PROPERTY, x11._OP_CREATE_GC,
               x11._OP_MAP_WINDOW):
        assert op in srv.opcodes
    w, h = vu.width(), vu.height()
    assert all(cw == w for cw, _ in srv.put_images)
    assert sum(ch for _, ch in srv.put_images) == 3 * h


# ---------------------------------------------------------------------------
# io/vu.py: the PNG tiling and the ANSI terminal loop
# ---------------------------------------------------------------------------
def test_viewer_png_matches_jax(tmp_path):
    from tensorforth_tpu.io.vu import view_corpus as jview
    from tensorforth_tpu_torch.io.vu import view_corpus
    p = view_corpus("mnist_test", str(tmp_path / "v.png"), n=16)
    q = jview("mnist_test", str(tmp_path / "j.png"), n=16)
    data = open(p, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    assert data == open(q, "rb").read()


def test_view_tensor_matches_jax(tmp_path):
    """view_tensor scales where the tensor lies; on values whose moments
    are exact in f32 its PNG is the JAX package's byte for byte"""
    from tensorforth_tpu.io.vu import view_tensor as jview
    from tensorforth_tpu_torch.io.vu import view_tensor
    t = (np.arange(6 * 4 * 4).reshape(6, 4, 4, 1) % 4).astype(np.float32)
    p = view_tensor(t, str(tmp_path / "p.png"), n_per_row=4)
    q = jview(t, str(tmp_path / "q.png"), n_per_row=4)
    assert open(p, "rb").read() == open(q, "rb").read()


def test_render_ansi_halfblocks():
    from tensorforth_tpu_torch.io.vu import render_ansi
    img = np.zeros((4, 3, 1), np.uint8)
    img[0, 0, 0] = 255
    lines = render_ansi(img)
    assert len(lines) == 2                       # 2 pixels per text row
    assert "\x1b[38;2;255;255;255m" in lines[0]  # top pixel as fg
    assert lines[0].count("▀") == 3
    assert lines[0].endswith("\x1b[0m")
    assert len(render_ansi(np.zeros((5, 3, 1), np.uint8))) == 3


def test_vu_interactive_loop_matches_jax():
    """the scripted keys njkrq page the same screens in both packages"""
    from tensorforth_tpu.io.vu import vu_loop as jloop
    from tensorforth_tpu_torch.io.vu import vu_loop
    outs = []
    for loop in (vu_loop, jloop):
        out = io.StringIO()
        assert loop("mnist_test", fin=io.StringIO("njkrq"), fout=out,
                    per_row=4) == 5
        outs.append(out.getvalue())
    text = outs[0]
    assert "mnist_test [0..3" in text and "[4..7" in text
    assert "[5..8" in text and "\x1b[48;2;" in text and "y=" in text
    assert outs[0] == outs[1]


def test_vu_cli_flag(monkeypatch, capsys):
    """`ten4_torch --vu mnist_test` with no display: the terminal loop"""
    from tensorforth_tpu_torch import cli
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.setattr(sys, "stdin", io.StringIO("q"))
    assert cli.main(["--vu", "mnist_test"]) == 0
    assert "mnist_test [0.." in capsys.readouterr().out
