"""Windowed corpus viewer — X11 (xcb) image window, no SDK headers (the
port of tensorforth_tpu/io/gui.py).

The reference ships an OpenGL/GLUT/SDL3 pixel-buffer viewer
(src/vu/gui.cpp: gui_init/gui_add/gui_loop with per-source display /
keyboard / mouse callbacks, src/vu/vu.h IRenderSource).  A server in a
rack has no display and no GL stack, so this viewer talks to the X
server directly: a ctypes binding to libxcb.so.1 (loaded when a display
is reachable; no dev headers needed) creates a window per render source and
blits numpy pixel pages with PutImage — the same corpus-browsing
semantics as the reference's mnist_vu (src/vu/mnist_vu.cu), including
its keyboard paging, without any GL/SDL dependency.

Layering (bottom-up):
  * ``_XCBLib``    — raw ctypes prototypes against libxcb.so.1.
  * ``XcbDisplay`` — semantic operations (connect, create_window,
                     put_image, wait_event, keysym translation).  Tests
                     substitute a fake with the same surface, so the
                     event loop and paging logic are covered headlessly
                     (tests/test_gui.py); the raw binding is exercised
                     end-to-end only when a real $DISPLAY exists.
  * ``CorpusVu``   — IRenderSource analog: width/height/pixels +
                     keyboard() paging (n/p/j/k/r/q, matching io/vu.py
                     and the reference's GLUT keyboard callback).
  * ``gui_init / gui_add / gui_loop`` — the reference's C API surface
                     (src/vu/vu.h:52-55), module-level.

When no display is reachable, ``gui_init`` returns False and the CLI
falls back to the ANSI terminal viewer (io/vu.py) — the reference
simply aborts in that situation (GLUT exits); degrading to the
in-terminal renderer is the deliberate deviation (docs/ARCHITECTURE.md
§Deviations).
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

# --- xcb constants (X11 core protocol) -------------------------------------
_XCB_WINDOW_CLASS_INPUT_OUTPUT = 1
_XCB_CW_BACK_PIXEL = 1 << 1
_XCB_CW_EVENT_MASK = 1 << 11
_XCB_EVENT_MASK_KEY_PRESS = 1 << 0
_XCB_EVENT_MASK_BUTTON_PRESS = 1 << 2
_XCB_EVENT_MASK_EXPOSURE = 1 << 15
_XCB_EVENT_MASK_STRUCTURE_NOTIFY = 1 << 17
_XCB_IMAGE_FORMAT_Z_PIXMAP = 2
_XCB_PROP_MODE_REPLACE = 0
_XCB_ATOM_WM_NAME = 39
_XCB_ATOM_STRING = 31
_EV_KEY_PRESS = 2
_EV_BUTTON_PRESS = 4
_EV_EXPOSE = 12
_EV_DESTROY_NOTIFY = 17
_PUT_CHUNK_BYTES = 200_000        # stay under the 256 KiB request cap


class _Cookie(ctypes.Structure):
    _fields_ = [("sequence", ctypes.c_uint)]


class _ScreenIter(ctypes.Structure):
    _fields_ = [("data", ctypes.c_void_p), ("rem", ctypes.c_int),
                ("index", ctypes.c_int)]


class _Screen(ctypes.Structure):
    _fields_ = [
        ("root", ctypes.c_uint32),
        ("default_colormap", ctypes.c_uint32),
        ("white_pixel", ctypes.c_uint32),
        ("black_pixel", ctypes.c_uint32),
        ("current_input_masks", ctypes.c_uint32),
        ("width_in_pixels", ctypes.c_uint16),
        ("height_in_pixels", ctypes.c_uint16),
        ("width_in_mm", ctypes.c_uint16),
        ("height_in_mm", ctypes.c_uint16),
        ("min_installed_maps", ctypes.c_uint16),
        ("max_installed_maps", ctypes.c_uint16),
        ("root_visual", ctypes.c_uint32),
        ("backing_stores", ctypes.c_uint8),
        ("save_unders", ctypes.c_uint8),
        ("root_depth", ctypes.c_uint8),
        ("allowed_depths_len", ctypes.c_uint8),
    ]


class _Setup(ctypes.Structure):
    # fixed head of xcb_setup_t (enough for the keycode range)
    _fields_ = [
        ("status", ctypes.c_uint8), ("pad0", ctypes.c_uint8),
        ("protocol_major_version", ctypes.c_uint16),
        ("protocol_minor_version", ctypes.c_uint16),
        ("length", ctypes.c_uint16),
        ("release_number", ctypes.c_uint32),
        ("resource_id_base", ctypes.c_uint32),
        ("resource_id_mask", ctypes.c_uint32),
        ("motion_buffer_size", ctypes.c_uint32),
        ("vendor_len", ctypes.c_uint16),
        ("maximum_request_length", ctypes.c_uint16),
        ("roots_len", ctypes.c_uint8),
        ("pixmap_formats_len", ctypes.c_uint8),
        ("image_byte_order", ctypes.c_uint8),
        ("bitmap_format_bit_order", ctypes.c_uint8),
        ("bitmap_format_scanline_unit", ctypes.c_uint8),
        ("bitmap_format_scanline_pad", ctypes.c_uint8),
        ("min_keycode", ctypes.c_uint8),
        ("max_keycode", ctypes.c_uint8),
    ]


class _KeyEvent(ctypes.Structure):
    _fields_ = [
        ("response_type", ctypes.c_uint8), ("detail", ctypes.c_uint8),
        ("sequence", ctypes.c_uint16), ("time", ctypes.c_uint32),
        ("root", ctypes.c_uint32), ("event", ctypes.c_uint32),
        ("child", ctypes.c_uint32),
        ("root_x", ctypes.c_int16), ("root_y", ctypes.c_int16),
        ("event_x", ctypes.c_int16), ("event_y", ctypes.c_int16),
        ("state", ctypes.c_uint16), ("same_screen", ctypes.c_uint8),
        ("pad0", ctypes.c_uint8),
    ]


class _KbReplyHead(ctypes.Structure):
    _fields_ = [
        ("response_type", ctypes.c_uint8),
        ("keysyms_per_keycode", ctypes.c_uint8),
        ("sequence", ctypes.c_uint16), ("length", ctypes.c_uint32),
        ("pad", ctypes.c_uint8 * 24),
    ]


def _load_xcb():
    """raw prototypes; raises OSError when libxcb is absent"""
    x = ctypes.CDLL("libxcb.so.1")
    p, u8, u16, u32, i16 = (ctypes.c_void_p, ctypes.c_uint8,
                            ctypes.c_uint16, ctypes.c_uint32,
                            ctypes.c_int16)
    x.xcb_connect.restype = p
    x.xcb_connect.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
    x.xcb_connection_has_error.restype = ctypes.c_int
    x.xcb_connection_has_error.argtypes = [p]
    x.xcb_disconnect.restype = None
    x.xcb_disconnect.argtypes = [p]
    x.xcb_get_setup.restype = ctypes.POINTER(_Setup)
    x.xcb_get_setup.argtypes = [p]
    x.xcb_setup_roots_iterator.restype = _ScreenIter
    x.xcb_setup_roots_iterator.argtypes = [ctypes.POINTER(_Setup)]
    x.xcb_generate_id.restype = u32
    x.xcb_generate_id.argtypes = [p]
    x.xcb_create_window.restype = _Cookie
    x.xcb_create_window.argtypes = [p, u8, u32, u32, i16, i16, u16, u16,
                                    u16, u16, u32, u32, p]
    x.xcb_map_window.restype = _Cookie
    x.xcb_map_window.argtypes = [p, u32]
    x.xcb_create_gc.restype = _Cookie
    x.xcb_create_gc.argtypes = [p, u32, u32, u32, p]
    x.xcb_put_image.restype = _Cookie
    x.xcb_put_image.argtypes = [p, u8, u32, u32, u16, u16, i16, i16,
                                u8, u8, u32, p]
    x.xcb_change_property.restype = _Cookie
    x.xcb_change_property.argtypes = [p, u8, u32, u32, u32, u8, u32, p]
    x.xcb_flush.restype = ctypes.c_int
    x.xcb_flush.argtypes = [p]
    x.xcb_wait_for_event.restype = ctypes.POINTER(_KeyEvent)
    x.xcb_wait_for_event.argtypes = [p]
    x.xcb_get_keyboard_mapping.restype = _Cookie
    x.xcb_get_keyboard_mapping.argtypes = [p, u8, u8]
    x.xcb_get_keyboard_mapping_reply.restype = ctypes.POINTER(_KbReplyHead)
    x.xcb_get_keyboard_mapping_reply.argtypes = [p, _Cookie, p]
    return x


class XcbDisplay:
    """semantic X connection: the only thing gui_loop talks to.

    Every method here maps 1:1 onto one or two xcb requests; tests
    replace the whole object (tests/test_gui.py FakeDisplay) so the
    loop/paging logic above this line runs without an X server."""

    def __init__(self):
        self._libc = ctypes.CDLL(None)
        self._libc.free.argtypes = [ctypes.c_void_p]
        self._libc.free.restype = None
        self._x = _load_xcb()
        scr = ctypes.c_int(0)
        self._c = self._x.xcb_connect(None, ctypes.byref(scr))
        if not self._c or self._x.xcb_connection_has_error(self._c):
            if self._c:
                self._x.xcb_disconnect(self._c)
            raise ConnectionError("no X display reachable "
                                  f"(DISPLAY={os.environ.get('DISPLAY')!r})")
        setup = self._x.xcb_get_setup(self._c)
        it = self._x.xcb_setup_roots_iterator(setup)
        self._screen = ctypes.cast(it.data, ctypes.POINTER(_Screen)).contents
        self._min_kc = setup.contents.min_keycode
        self._keysyms = self._keyboard_map(setup.contents)
        # put_image assumes LSBFirst BGRX at depth 24/32; reject
        # servers where that blit would scramble channels (ADVICE r4)
        self._lsb_first = setup.contents.image_byte_order == 0
        if self._screen.root_depth not in (24, 32):
            self._x.xcb_disconnect(self._c)
            raise ConnectionError(
                f"unsupported root depth {self._screen.root_depth} "
                "(viewer blits depth-24/32 ZPixmap)")
        self._gc = None

    # -- keyboard ------------------------------------------------------
    def _keyboard_map(self, setup) -> list[int]:
        """first keysym per keycode (plain, unshifted)"""
        n = setup.max_keycode - setup.min_keycode + 1
        ck = self._x.xcb_get_keyboard_mapping(self._c, setup.min_keycode, n)
        rep = self._x.xcb_get_keyboard_mapping_reply(self._c, ck, None)
        if not rep:
            return []
        per = rep.contents.keysyms_per_keycode
        total = rep.contents.length
        syms = ctypes.cast(
            ctypes.addressof(rep.contents) + ctypes.sizeof(_KbReplyHead),
            ctypes.POINTER(ctypes.c_uint32 * total)).contents
        out = [syms[i * per] if i * per < total else 0 for i in range(n)]
        self._libc.free(rep)
        return out

    def keysym(self, keycode: int) -> str:
        """keycode -> one-char string for latin-1 keysyms; Escape
        (XK_Escape 0xFF1B) maps to '\\x1b' so the viewer's quit branch
        is reachable from a real keyboard (ADVICE r4), else ''"""
        i = keycode - self._min_kc
        if 0 <= i < len(self._keysyms):
            ks = self._keysyms[i]
            if 0 < ks < 256:
                return chr(ks)
            if ks == 0xFF1B:                    # XK_Escape
                return "\x1b"
        return ""

    # -- window / drawing ----------------------------------------------
    def create_window(self, w: int, h: int, title: str) -> int:
        x = self._x
        win = x.xcb_generate_id(self._c)
        mask = _XCB_CW_BACK_PIXEL | _XCB_CW_EVENT_MASK
        vals = (ctypes.c_uint32 * 2)(
            self._screen.black_pixel,
            _XCB_EVENT_MASK_EXPOSURE | _XCB_EVENT_MASK_KEY_PRESS
            | _XCB_EVENT_MASK_BUTTON_PRESS
            | _XCB_EVENT_MASK_STRUCTURE_NOTIFY)
        x.xcb_create_window(self._c, self._screen.root_depth, win,
                            self._screen.root, 0, 0, w, h, 1,
                            _XCB_WINDOW_CLASS_INPUT_OUTPUT,
                            self._screen.root_visual, mask, vals)
        t = title.encode()
        x.xcb_change_property(self._c, _XCB_PROP_MODE_REPLACE, win,
                              _XCB_ATOM_WM_NAME, _XCB_ATOM_STRING, 8,
                              len(t), t)
        if self._gc is None:
            self._gc = x.xcb_generate_id(self._c)
            x.xcb_create_gc(self._c, self._gc, win, 0, None)
        x.xcb_map_window(self._c, win)
        x.xcb_flush(self._c)
        return win

    def put_image(self, win: int, img: np.ndarray) -> None:
        """blit [h,w,3] uint8 RGB at (0,0) — ZPixmap depth-24 BGRX,
        chunked by rows to stay under the X request size cap"""
        h, w = img.shape[:2]
        bgrx = np.zeros((h, w, 4), np.uint8)
        if self._lsb_first:                     # BGRX little-endian
            bgrx[..., 0] = img[..., 2]
            bgrx[..., 1] = img[..., 1]
            bgrx[..., 2] = img[..., 0]
        else:                                   # MSBFirst: XRGB
            bgrx[..., 1] = img[..., 0]
            bgrx[..., 2] = img[..., 1]
            bgrx[..., 3] = img[..., 2]
        rows = max(1, _PUT_CHUNK_BYTES // (w * 4))
        for y0 in range(0, h, rows):
            chunk = np.ascontiguousarray(bgrx[y0:y0 + rows])
            self._x.xcb_put_image(
                self._c, _XCB_IMAGE_FORMAT_Z_PIXMAP, win, self._gc,
                w, chunk.shape[0], 0, y0, 0, self._screen.root_depth,
                chunk.nbytes, chunk.ctypes.data_as(ctypes.c_void_p))
        self._x.xcb_flush(self._c)

    # -- events ----------------------------------------------------------
    def wait_event(self):
        """block for one event -> ('key', ch) | ('button', (b, x, y)) |
        ('expose', None) | ('close', None) | (None, None) otherwise"""
        ev = self._x.xcb_wait_for_event(self._c)
        if not ev:
            return ("close", None)
        try:
            t = ev.contents.response_type & 0x7F
            if t == _EV_KEY_PRESS:
                return ("key", self.keysym(ev.contents.detail))
            if t == _EV_BUTTON_PRESS:
                # same wire layout as KeyPress: detail = button number
                return ("button", (ev.contents.detail,
                                   ev.contents.event_x,
                                   ev.contents.event_y))
            if t == _EV_EXPOSE:
                return ("expose", None)
            if t == _EV_DESTROY_NOTIFY:
                return ("close", None)
            return (None, None)
        finally:
            self._libc.free(ev)

    def close(self) -> None:
        if self._c:
            self._x.xcb_disconnect(self._c)
            self._c = None


class CorpusVu:
    """IRenderSource analog (reference src/vu/vu.h:20-41 + the mnist_vu
    page renderer): holds a corpus, renders `per_row` samples per page
    at an integer upscale, pages on the same keys as the terminal
    viewer (n/p page, j/k step, r rewind, q quit)."""

    def __init__(self, corpus, per_row: int = 6, tile_px: int = 112):
        corpus.init()
        self.corpus = corpus
        self.per_row = per_row
        self.n_show = min(corpus.size, 512)
        self.data, self.labels = corpus._read(0, self.n_show)
        self.pos = 0
        self.scale = max(1, tile_px // corpus.H)
        self._h = corpus.H * self.scale
        self._w = corpus.W * self.scale
        self.done = False

    def width(self) -> int:
        return self.per_row * (self._w + 2)

    def height(self) -> int:
        return self._h + 2

    def title(self) -> str:
        return f"ten4 vu: {getattr(self.corpus, 'name', 'corpus')}"

    def pixels(self) -> np.ndarray:
        """current page as [height(), width(), 3] uint8"""
        page = np.zeros((self.height(), self.width(), 3), np.uint8)
        for i in range(self.per_row):
            j = self.pos + i
            if j >= self.n_show:
                break
            img = np.asarray(self.data[j], np.uint8)
            img3 = img if img.shape[-1] == 3 else np.repeat(img[..., :1], 3, -1)
            big = np.repeat(np.repeat(img3[:, :, :3], self.scale, 0),
                            self.scale, 1)
            x0 = i * (self._w + 2)
            page[1:1 + self._h, x0:x0 + self._w] = big
        return page

    def keyboard(self, ch: str) -> bool:
        """returns True when the page changed (needs redraw)"""
        old = self.pos
        if ch in ("q", "\x1b"):
            self.done = True
        elif ch == "n":
            self.pos = min(self.pos + self.per_row,
                           max(self.n_show - self.per_row, 0))
        elif ch == "p":
            self.pos = max(self.pos - self.per_row, 0)
        elif ch == "j":
            self.pos = min(self.pos + 1, self.n_show - 1)
        elif ch == "k":
            self.pos = max(self.pos - 1, 0)
        elif ch == "r":
            self.pos = 0
        return self.pos != old

    def mouse(self, button: int, x: int, y: int) -> bool:
        """reference IRenderSource::mouse analog (vu.h:34): left click
        pages forward, right pages back, wheel (buttons 4/5) steps"""
        return self.keyboard({1: "n", 3: "p", 4: "k", 5: "j"}.get(
            button, ""))


# ===========================================================================
# module-level API, mirroring the reference's extern "C" surface
# (src/vu/vu.h:52-55: gui_init / gui_add / gui_loop)
# ===========================================================================
_display: XcbDisplay | None = None
_sources: list[tuple[int, CorpusVu]] = []


def gui_init(display=None) -> bool:
    """connect to the X server; False (no raise) when unreachable so
    the CLI can fall back to the terminal viewer.  `display` injects a
    fake for tests."""
    global _display
    _sources.clear()
    if display is not None:
        _display = display
        return True
    try:
        _display = XcbDisplay()
        return True
    except (OSError, ConnectionError):
        _display = None
        return False


def gui_add(vu: CorpusVu) -> int:
    """create a window for one render source (reference gui_add)"""
    assert _display is not None, "gui_init first"
    win = _display.create_window(vu.width(), vu.height(), vu.title())
    _sources.append((win, vu))
    return win


def gui_loop() -> int:
    """blocking event loop: expose -> blit, keys -> paging, q/close ->
    exit.  Returns the number of frames blitted."""
    assert _display is not None, "gui_init first"
    frames = 0
    try:
        while _sources:
            kind, arg = _display.wait_event()
            if kind == "close":
                break
            if kind == "expose":
                for win, vu in _sources:
                    _display.put_image(win, vu.pixels())
                    frames += 1
            elif kind in ("key", "button"):
                redraw = False
                for _, vu in _sources:
                    if kind == "key":
                        redraw = vu.keyboard(arg) or redraw
                    else:
                        redraw = vu.mouse(*arg) or redraw
                if any(vu.done for _, vu in _sources):
                    break
                if redraw:
                    for win, vu in _sources:
                        _display.put_image(win, vu.pixels())
                        frames += 1
    finally:
        _display.close()
    return frames


def vu_window(name: str, per_row: int = 6) -> int:
    """one-call corpus browser in an X window (CLI --vu entry when a
    display is reachable); returns frames drawn, or -1 if no display"""
    from .loader import Loader
    if not gui_init():
        return -1
    cp = Loader.get(None, name)
    if cp is None:
        _display.close()
        raise FileNotFoundError(name)
    gui_add(CorpusVu(cp, per_row=per_row))
    return gui_loop()
