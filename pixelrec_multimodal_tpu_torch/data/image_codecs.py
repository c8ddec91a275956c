# pixelrec_multimodal_tpu_torch/data/image_codecs.py
"""The image decoders of the image tier's offline mode, and how one is
chosen.

The JAX package validates images with PIL (``data/preprocessing.py``:
verify and load, then ``img.size``). A machine may lack PIL, so the port
chooses, once per run and outside any per-file ``try``
(``image_decoder``):

- PIL where it is installed: the JAX package's calls, so the verdicts are
  PIL's;
- else nvJPEG on the card where the caller's device is ``cuda``: the
  CUDA toolkit's JPEG decoder (``libnvjpeg``), bound through
  ``data/csrc/jpeg_decode.cu``, which is built at first use like the
  kernels (``ops/_build.py``, linked with ``-lnvjpeg``);
- else ``ImageCodecMissing``, naming ROADMAP item A12.

No choice falls back: without a decoder the run raises, and no file is
marked corrupt for want of one.

A file counts as corrupt under nvJPEG when its full decode fails:
``nvjpegGetImageInfo`` or ``nvjpegDecode`` reports a bad or incomplete
stream, or the stream ends before its end-of-image marker
(``jpeg_complete``). PIL's ``load()`` raises "image file is truncated" on
such a file, and nvJPEG may decode it without an error. nvJPEG decodes
JPEG only: a PNG, GIF, BMP, WebP or TIFF file, or a JPEG that nvJPEG does
not support, raises ``ImageCodecMissing``; other bytes are corrupt, as PIL
finds them.

Nothing here imports PIL or builds anything at import time.
"""
from __future__ import annotations

import ctypes
import queue
import threading
from pathlib import Path
from typing import Optional, Tuple

import torch

from ..ops import _build

JPEG_SOURCE = 'jpeg_decode'
_build.register_source(JPEG_SOURCE, Path(__file__).resolve().parent / 'csrc',
                       libraries=('nvjpeg',))
# Formats PIL reads that nvJPEG does not, by their leading bytes.
_OTHER_FORMATS = ((b'\x89PNG\r\n\x1a\n', 'PNG'), (b'GIF87a', 'GIF'),
                  (b'GIF89a', 'GIF'), (b'BM', 'BMP'), (b'II*\x00', 'TIFF'),
                  (b'MM\x00*', 'TIFF'))
# nvjpegStatus_t
_BAD_JPEG, _NOT_SUPPORTED, _NOT_IMPLEMENTED, _INCOMPLETE = 3, 4, 9, 10
# Markers with no length: TEM, RST0-7, SOI.
_STANDALONE = frozenset((0x01, *range(0xD0, 0xD9)))


class ImageCodecMissing(ImportError):
    """No decoder or encoder on this machine for what was asked (ROADMAP
    item A12). The offline mode's per-file ``try`` lets it through."""


def pil_image():
    """PIL's ``Image`` module; raises ``ImageCodecMissing`` where PIL is
    not installed."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImageCodecMissing(
            'decoding or encoding this image needs PIL, which is not '
            'installed here (ROADMAP item A12: nvJPEG on the card validates '
            'JPEG files only)') from e
    return Image


def jpeg_complete(data: bytes) -> bool:
    """True if ``data`` is a JPEG stream that reaches its end-of-image
    marker: the marker segments walked from the start-of-image, each
    scan's entropy-coded data skipped to the next marker (a 0xFF there is
    followed by 0x00 or a restart marker), until EOI after at least one
    scan."""
    n, pos, scans = len(data), 2, 0
    if data[:2] != b'\xff\xd8':
        return False
    while pos + 1 < n:
        if data[pos] != 0xFF:
            return False
        marker = data[pos + 1]
        if marker == 0xFF:  # fill byte
            pos += 1
            continue
        if marker == 0xD9:
            return scans > 0
        if marker in _STANDALONE:
            pos += 2
            continue
        if pos + 3 >= n:
            return False
        pos += 2 + ((data[pos + 2] << 8) | data[pos + 3])
        if marker != 0xDA:
            continue
        scans += 1
        while True:  # the scan's entropy-coded data
            pos = data.find(b'\xff', pos)
            if pos < 0 or pos + 1 >= n:
                return False
            follow = data[pos + 1]
            if follow == 0x00 or 0xD0 <= follow <= 0xD7:
                pos += 2
            elif follow == 0xFF:
                pos += 1
            else:
                break
    return False


class PilDecoder:
    """The JAX package's checks, on PIL."""
    name = 'PIL'

    def __init__(self):
        self.image = pil_image()

    def corrupted(self, path: str) -> bool:
        try:
            with self.image.open(path) as img:
                img.verify()
            with self.image.open(path) as img:
                img.load()
            return False
        except Exception:
            return True

    def size(self, path: str) -> Tuple[int, int]:
        with self.image.open(path) as img:
            return img.size


class NvjpegDecoder:
    """JPEG files decoded on the card by nvJPEG (``data/csrc/
    jpeg_decode.cu``): ``info`` from ``nvjpegGetImageInfo``, ``decode`` to
    an RGB uint8 H x W x 3 tensor on the card (``NVJPEG_OUTPUT_RGBI``; a
    grayscale file as ``NVJPEG_OUTPUT_Y``, repeated over the three
    channels, as PIL's ``convert('RGB')`` does), on the current stream.
    ``decodes`` counts the decodes that reached the library. Threads may
    share a decoder: each decode borrows a slot (an nvJPEG decode state
    and a scratch buffer on the card) from a pool that grows to the number
    of concurrent callers, so their host-side Huffman passes overlap.
    ``size`` reuses the header that its thread's last ``corrupted`` read
    from the same path, so an item's checks read its file once."""
    name = 'nvJPEG'

    def __init__(self, device='cuda'):
        self.device = torch.device(device)
        if self.device.type != 'cuda':
            raise ValueError(f'nvJPEG decodes on a CUDA device, not '
                             f'{self.device}')
        self.decodes = 0
        self._lib = None
        self._lock = threading.Lock()
        self._slots = queue.SimpleQueue()
        self._local = threading.local()

    def _library(self):
        with self._lock:
            if self._lib is None:
                lib = _build.load(JPEG_SOURCE)
                lib.jpeg_state_create.argtypes = [
                    ctypes.POINTER(ctypes.c_void_p)]
                lib.jpeg_state_create.restype = ctypes.c_int
                lib.jpeg_info.argtypes = [ctypes.c_char_p, ctypes.c_longlong,
                                          ctypes.POINTER(ctypes.c_int)]
                lib.jpeg_info.restype = ctypes.c_int
                lib.jpeg_decode.argtypes = [
                    ctypes.c_void_p, ctypes.c_char_p, ctypes.c_longlong,
                    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                    ctypes.c_void_p]
                lib.jpeg_decode.restype = ctypes.c_int
                self._lib = lib
            return self._lib

    @staticmethod
    def _check_format(data: bytes, what: str):
        for magic, fmt in _OTHER_FORMATS:
            if data.startswith(magic):
                raise ImageCodecMissing(
                    f'{what}: a {fmt} file, and this machine decodes only '
                    'JPEG (nvJPEG on the card; PIL is not installed; '
                    'ROADMAP item A12)')
        if data[:4] == b'RIFF' and data[8:12] == b'WEBP':
            raise ImageCodecMissing(f'{what}: a WebP file, and this machine '
                                    'decodes only JPEG (ROADMAP item A12)')

    def _status(self, status: int, what: str) -> bool:
        """True for a decoded stream, False for a bad or incomplete one;
        raises for one nvJPEG does not support or for a failure of the
        library or the card."""
        if status == 0:
            return True
        if status in (_BAD_JPEG, _INCOMPLETE):
            return False
        if status in (_NOT_SUPPORTED, _NOT_IMPLEMENTED):
            raise ImageCodecMissing(f'{what}: a JPEG that nvJPEG does not '
                                    f'support (status {status}; ROADMAP '
                                    'item A12)')
        raise RuntimeError(f'{what}: nvJPEG failed with status {status}'
                           if status > 0 else
                           f'{what}: CUDA error {-status} in the decode')

    def info(self, data: bytes, what: str = 'image'
             ) -> Optional[Tuple[int, int, int]]:
        """(width, height, components) of a JPEG stream, or None where
        nvJPEG finds no valid header."""
        self._check_format(data, what)
        out = (ctypes.c_int * 4)()
        if not self._status(self._library().jpeg_info(data, len(data), out),
                            what):
            return None
        return out[2], out[3], out[0]

    def _slot(self) -> list:
        """A free [decode state, scratch buffer] pair, made if none is."""
        try:
            return self._slots.get_nowait()
        except queue.Empty:
            state = ctypes.c_void_p()
            status = self._library().jpeg_state_create(ctypes.byref(state))
            if status != 0:
                raise RuntimeError(f'nvJPEG: no decode state (status '
                                   f'{status})')
            return [state, None]

    def _decode(self, data: bytes, what: str, hdr: Tuple[int, int, int],
                keep: bool, eoi: bool = True):
        """nvJPEG's status and the frame of a JPEG stream whose header
        ``info`` read as ``hdr``. Without ``keep`` the frame lies in the
        slot's scratch buffer, which the next decode overwrites, and
        serves as a verdict only. With ``eoi`` a stream cut before its
        end-of-image marker is not decoded (status ``_INCOMPLETE``)."""
        if eoi and not jpeg_complete(data):
            return _INCOMPLETE, None
        width, height, components = hdr
        shape = (height, width, 1 if components == 1 else 3)
        n = shape[0] * shape[1] * shape[2]
        stream = torch.cuda.current_stream(self.device).cuda_stream
        slot = self._slot()
        try:
            if keep:
                out = torch.empty(shape, dtype=torch.uint8,
                                  device=self.device)
            else:
                # a fresh tensor a file cost about as much as the decode
                if slot[1] is None or slot[1].numel() < n:
                    slot[1] = torch.empty(max(n, 1 << 20), dtype=torch.uint8,
                                          device=self.device)
                out = slot[1][:n].view(shape)
            status = self._library().jpeg_decode(
                slot[0], data, len(data), out.data_ptr(), out.stride(0),
                int(components == 1), stream)
        finally:
            self._slots.put(slot)
        with self._lock:
            self.decodes += 1
        return status, (out.expand(height, width, 3) if components == 1
                        else out)

    def decode(self, data: bytes, what: str = 'image'
               ) -> Optional[torch.Tensor]:
        """The RGB uint8 frame of a JPEG stream on the card, or None where
        its full decode fails (including a stream cut before its
        end-of-image marker)."""
        hdr = self.info(data, what)
        if hdr is None:
            return None
        status, out = self._decode(data, what, hdr, keep=True)
        return out if self._status(status, what) else None

    def library_status(self, data: bytes, what: str = 'image'
                       ) -> Optional[int]:
        """nvJPEG's own status for the full decode of ``data``, without
        the end-of-image check (for reports); None without a header."""
        hdr = self.info(data, what)
        return None if hdr is None else self._decode(
            data, what, hdr, keep=False, eoi=False)[0]

    def check(self, data: bytes, what: str = 'image'
              ) -> Optional[Tuple[int, int, int]]:
        """The header (``info``) of a JPEG stream whose full decode
        succeeds, else None; decoded into a slot's scratch buffer."""
        hdr = self.info(data, what)
        if hdr is None or not self._status(
                self._decode(data, what, hdr, keep=False)[0], what):
            return None
        return hdr

    def corrupted(self, path: str) -> bool:
        hdr = self.check(Path(path).read_bytes(), str(path))
        self._local.header = (str(path), hdr)
        return hdr is None

    def size(self, path: str) -> Tuple[int, int]:
        last, hdr = getattr(self._local, 'header', (None, None))
        if last != str(path) or hdr is None:
            hdr = self.info(Path(path).read_bytes(), str(path))
        if hdr is None:
            raise ValueError(f'{path}: no JPEG header nvJPEG can read')
        return hdr[0], hdr[1]


def image_decoder(device='cpu'):
    """The offline mode's decoder: PIL where it is installed, else nvJPEG
    when ``device`` is a CUDA device and the toolkit has ``libnvjpeg``,
    else ``ImageCodecMissing``."""
    try:
        return PilDecoder()
    except ImageCodecMissing as e:
        missing = e
    if torch.device(device).type != 'cuda':
        raise ImageCodecMissing(
            f'validating images needs PIL, which is not installed here, or '
            f'nvJPEG on a CUDA device (the device is {device}); ROADMAP '
            f'item A12') from missing
    if _build.toolkit_library('nvjpeg') is None:
        raise ImageCodecMissing(
            'validating images needs PIL, which is not installed here, or '
            'the CUDA toolkit\'s libnvjpeg, which is not under '
            '$CUDA_HOME/lib64 or /usr/local/cuda/lib64; ROADMAP item A12'
        ) from missing
    return NvjpegDecoder(device)
