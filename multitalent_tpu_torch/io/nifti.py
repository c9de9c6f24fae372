"""Self-contained NIfTI-1 reader/writer.

The reference delegates NIfTI I/O to SimpleITK (nnunet/preprocessing/cropping.py:61-81,
nnunet/inference/segmentation_export.py:148-152). Neither SimpleITK nor nibabel is a
dependency here, so we implement the format directly: 348-byte NIfTI-1 header, optional
gzip container, sform/qform geometry.

Conventions match SimpleITK so downstream logic is interchangeable with the reference:
- arrays are returned in index order [z, y, x] (or [t, z, y, x] for 4D), like
  `sitk.GetArrayFromImage`;
- `Geometry.spacing/origin/direction` are in **LPS** world coordinates with spacing and
  origin ordered (x, y, z) and direction a row-major 3x3 matrix whose *columns* are the
  voxel-axis directions, exactly like `GetSpacing/GetOrigin/GetDirection`.

The port's copy of multitalent_tpu/io/nifti.py; gzip containers are read with
Python's `gzip` (the JAX package's optional native decompressor is not carried).
"""
from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

# nifti datatype code -> numpy dtype
_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}

_LPS_FROM_RAS = np.diag([-1.0, -1.0, 1.0])


@dataclass
class Geometry:
    """ITK-style image geometry in LPS world coordinates."""

    spacing: tuple[float, float, float] = (1.0, 1.0, 1.0)  # (x, y, z)
    origin: tuple[float, float, float] = (0.0, 0.0, 0.0)
    direction: tuple[float, ...] = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)
    extra: dict = field(default_factory=dict)

    def direction_matrix(self) -> np.ndarray:
        return np.asarray(self.direction, dtype=np.float64).reshape(3, 3)

    def affine_lps(self) -> np.ndarray:
        """4x4 affine mapping voxel index (i, j, k) -> LPS world coordinates."""
        a = np.eye(4)
        a[:3, :3] = self.direction_matrix() @ np.diag(self.spacing)
        a[:3, 3] = self.origin
        return a

    @classmethod
    def from_affine_lps(cls, affine: np.ndarray) -> "Geometry":
        m = affine[:3, :3]
        spacing = np.linalg.norm(m, axis=0)
        spacing = np.where(spacing == 0, 1.0, spacing)
        direction = m / spacing[None, :]
        return cls(
            spacing=tuple(float(s) for s in spacing),
            origin=tuple(float(o) for o in affine[:3, 3]),
            direction=tuple(float(d) for d in direction.reshape(-1)),
        )


def _open_maybe_gzip(path: Path) -> bytes:
    raw = path.read_bytes()
    if raw[:2] == b"\x1f\x8b":
        return gzip.decompress(raw)
    return raw


def _parse_header(buf: bytes):
    if len(buf) < 348:
        raise ValueError("file too small to be NIfTI-1")
    (sizeof_hdr,) = struct.unpack_from("<i", buf, 0)
    if sizeof_hdr == 348:
        endian = "<"
    elif struct.unpack_from(">i", buf, 0)[0] == 348:
        endian = ">"
    else:
        raise ValueError("not a NIfTI-1 file (sizeof_hdr != 348)")
    magic = buf[344:348]
    if magic[:3] not in (b"n+1", b"ni1"):
        raise ValueError(f"bad NIfTI magic: {magic!r}")

    dim = struct.unpack_from(endian + "8h", buf, 40)
    datatype, bitpix = struct.unpack_from(endian + "2h", buf, 70)
    pixdim = struct.unpack_from(endian + "8f", buf, 76)
    (vox_offset,) = struct.unpack_from(endian + "f", buf, 108)
    scl_slope, scl_inter = struct.unpack_from(endian + "2f", buf, 112)
    qform_code, sform_code = struct.unpack_from(endian + "2h", buf, 252)
    quatern = struct.unpack_from(endian + "6f", buf, 256)  # b c d, qoffset x y z
    srow = np.array(struct.unpack_from(endian + "12f", buf, 280), dtype=np.float64).reshape(3, 4)
    return {
        "endian": endian,
        "dim": dim,
        "datatype": datatype,
        "bitpix": bitpix,
        "pixdim": pixdim,
        "vox_offset": int(vox_offset) if vox_offset > 0 else 352,
        "scl_slope": scl_slope,
        "scl_inter": scl_inter,
        "qform_code": qform_code,
        "sform_code": sform_code,
        "quatern": quatern,
        "srow": srow,
    }


def _affine_ras_from_header(h) -> np.ndarray:
    if h["sform_code"] > 0:
        a = np.eye(4)
        a[:3, :] = h["srow"]
        return a
    pixdim = h["pixdim"]
    if h["qform_code"] > 0:
        b, c, d, ox, oy, oz = h["quatern"]
        a2 = max(0.0, 1.0 - b * b - c * c - d * d)
        a_ = np.sqrt(a2)
        r = np.array(
            [
                [a_ * a_ + b * b - c * c - d * d, 2 * (b * c - a_ * d), 2 * (b * d + a_ * c)],
                [2 * (b * c + a_ * d), a_ * a_ + c * c - b * b - d * d, 2 * (c * d - a_ * b)],
                [2 * (b * d - a_ * c), 2 * (c * d + a_ * b), a_ * a_ + d * d - b * b - c * c],
            ]
        )
        qfac = -1.0 if pixdim[0] < 0 else 1.0
        sp = np.array([abs(pixdim[1]), abs(pixdim[2]), abs(pixdim[3]) * qfac])
        aff = np.eye(4)
        aff[:3, :3] = r @ np.diag(sp)
        aff[:3, 3] = (ox, oy, oz)
        return aff
    aff = np.diag([abs(pixdim[1]) or 1.0, abs(pixdim[2]) or 1.0, abs(pixdim[3]) or 1.0, 1.0])
    return aff


def read_nifti(path: str | Path, dtype=None) -> tuple[np.ndarray, Geometry]:
    """Read a .nii / .nii.gz file.

    Returns (array, geometry): array in [z, y, x] (3D) or [t, z, y, x] (4D) index order.
    """
    path = Path(path)
    buf = _open_maybe_gzip(path)
    h = _parse_header(buf)
    ndim = h["dim"][0]
    if ndim not in (2, 3, 4):
        raise ValueError(f"unsupported NIfTI ndim {ndim}")
    nx = h["dim"][1]
    ny = h["dim"][2] if ndim >= 2 else 1
    nz = h["dim"][3] if ndim >= 3 else 1
    nt = h["dim"][4] if ndim >= 4 else 1

    np_dtype = _DTYPES.get(h["datatype"])
    if np_dtype is None:
        raise ValueError(f"unsupported NIfTI datatype code {h['datatype']}")
    count = nx * ny * nz * nt
    arr = np.frombuffer(
        buf, dtype=np.dtype(np_dtype).newbyteorder(h["endian"]), count=count, offset=h["vox_offset"]
    )
    # disk layout: x fastest -> C-order reshape (t, z, y, x) puts x last
    arr = arr.reshape((nt, nz, ny, nx))
    if ndim < 4:
        arr = arr[0]

    slope, inter = h["scl_slope"], h["scl_inter"]
    if slope not in (0.0, 1.0) or inter != 0.0:
        if slope == 0.0:
            slope = 1.0
        arr = arr.astype(np.float32) * np.float32(slope) + np.float32(inter)
    elif arr.dtype.byteorder not in ("=", "|"):
        arr = arr.astype(arr.dtype.newbyteorder("="))
    if dtype is not None:
        arr = arr.astype(dtype)

    affine_ras = _affine_ras_from_header(h)
    affine_lps = np.eye(4)
    affine_lps[:3, :] = _LPS_FROM_RAS @ affine_ras[:3, :]
    geom = Geometry.from_affine_lps(affine_lps)
    return np.ascontiguousarray(arr), geom


def write_nifti(path: str | Path, array_zyx: np.ndarray, geometry: Geometry | None = None,
                dtype=None, compress: bool | None = None) -> None:
    """Write [z, y, x] (or [t, z, y, x]) array to .nii / .nii.gz with sform geometry."""
    path = Path(path)
    geometry = geometry or Geometry()
    arr = np.asarray(array_zyx)
    if dtype is not None:
        arr = arr.astype(dtype)
    if arr.dtype == np.bool_:
        arr = arr.astype(np.uint8)
    if arr.dtype not in _DTYPE_CODES:
        arr = arr.astype(np.float32)
    if arr.ndim == 3:
        nt, (nz, ny, nx) = 1, arr.shape
        ndim = 3
    elif arr.ndim == 4:
        (nt, nz, ny, nx) = arr.shape
        ndim = 4
    else:
        raise ValueError(f"expected 3D/4D array, got shape {arr.shape}")

    affine_ras = np.eye(4)
    affine_ras[:3, :] = _LPS_FROM_RAS @ geometry.affine_lps()[:3, :]

    hdr = bytearray(352)
    struct.pack_into("<i", hdr, 0, 348)
    dim = [ndim, nx, ny, nz, nt, 1, 1, 1]
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<2h", hdr, 70, _DTYPE_CODES[arr.dtype], arr.dtype.itemsize * 8)
    sx, sy, sz = geometry.spacing
    struct.pack_into("<8f", hdr, 76, 1.0, sx, sy, sz, 1.0, 0.0, 0.0, 0.0)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<2f", hdr, 112, 1.0, 0.0)  # scl_slope/inter
    struct.pack_into("<b", hdr, 123, 10)  # xyzt_units: mm | sec
    struct.pack_into("<2h", hdr, 252, 0, 2)  # qform_code=0, sform_code=2 (aligned)
    struct.pack_into("<12f", hdr, 280, *affine_ras[:3, :].reshape(-1).astype(np.float32))
    hdr[344:348] = b"n+1\x00"

    # disk layout must be x fastest: C-contiguous (t, z, y, x) already is.
    payload = bytes(hdr) + np.ascontiguousarray(arr).tobytes()
    if compress is None:
        compress = path.name.endswith(".gz")
    path.parent.mkdir(parents=True, exist_ok=True)
    if compress:
        gz = gzip.compress(payload, compresslevel=1)
        path.write_bytes(gz)
    else:
        path.write_bytes(payload)
