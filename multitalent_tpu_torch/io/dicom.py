"""Minimal DICOM CT-series reader: series directory -> (volume, Geometry).

The port's copy of multitalent_tpu/io/dicom.py (host numpy only).

Purpose: the TCIA datasets behind Task062 (NIH Pancreas-CT) and Task046
(AbdOrgSegm2) ship as DICOM series; the reference converts them with
dicom2nifti (nnunet/dataset_conversion/Task062_NIHPancreas.py:33-60), which —
like every DICOM library — is not in this image. This module vendors the
small subset needed for those datasets: single-frame, uncompressed,
little-endian (implicit or explicit VR) CT slices, assembled into a 3-D
volume with ITK/LPS geometry matching our NIfTI codec (io/nifti.Geometry).

Deliberately NOT a general DICOM implementation: compressed transfer
syntaxes, big-endian, multi-frame, and non-axial-consistent series raise
ValueError with a pointer to an external conversion.
"""
from __future__ import annotations

import os
import struct
from pathlib import Path

import numpy as np

from multitalent_tpu_torch.io.nifti import Geometry, write_nifti

_IMPLICIT_LE = "1.2.840.10008.1.2"
_EXPLICIT_LE = "1.2.840.10008.1.2.1"

# tags we extract; value kind drives parsing under implicit VR
_WANTED = {
    (0x0020, 0x0032): ("ImagePositionPatient", "ds"),
    (0x0020, 0x0037): ("ImageOrientationPatient", "ds"),
    (0x0028, 0x0030): ("PixelSpacing", "ds"),
    (0x0028, 0x0010): ("Rows", "us"),
    (0x0028, 0x0011): ("Columns", "us"),
    (0x0028, 0x0100): ("BitsAllocated", "us"),
    (0x0028, 0x0103): ("PixelRepresentation", "us"),
    (0x0028, 0x1052): ("RescaleIntercept", "ds"),
    (0x0028, 0x1053): ("RescaleSlope", "ds"),
    (0x0020, 0x0013): ("InstanceNumber", "is"),
    (0x7FE0, 0x0010): ("PixelData", "bytes"),
}

_LONG_VRS = {b"OB", b"OW", b"OF", b"OD", b"OL", b"SQ", b"UT", b"UN", b"UC",
             b"UR"}


def _parse_value(kind: str, raw: bytes):
    if kind == "ds":
        return [float(v) for v in raw.decode("ascii").strip("\x00 ").split("\\")
                if v.strip()]
    if kind == "is":
        s = raw.decode("ascii").strip("\x00 ")
        return int(s) if s else None
    if kind == "us":
        return struct.unpack("<H", raw[:2])[0]
    return raw


def _skip_undefined_sq(buf: bytes, pos: int) -> int:
    """Skip an undefined-length sequence: walk items until the sequence
    delimitation item (FFFE,E0DD)."""
    n = len(buf)
    while pos + 8 <= n:
        group, elem, length = struct.unpack("<HHI", buf[pos:pos + 8])
        pos += 8
        if (group, elem) == (0xFFFE, 0xE0DD):
            return pos
        if (group, elem) == (0xFFFE, 0xE000):
            if length == 0xFFFFFFFF:
                # undefined-length item: scan to item delimiter, allowing
                # nested sequences (rare in CT; handled by recursion on SQ
                # elements inside would require full parsing — scan linearly
                # for the delimiter tag instead, which is valid because
                # uncompressed CT items carry no nested undefined lengths)
                end = buf.find(b"\xfe\xff\x0d\xe0", pos)
                if end < 0:
                    raise ValueError("unterminated DICOM sequence item")
                pos = end + 8
            else:
                pos += length
        else:
            raise ValueError("malformed DICOM sequence")
    raise ValueError("unterminated DICOM sequence")


def _parse_dataset(buf: bytes, pos: int, explicit: bool) -> dict:
    out = {}
    n = len(buf)
    while pos + 8 <= n:
        group, elem = struct.unpack("<HH", buf[pos:pos + 4])
        if explicit and group != 0xFFFE:
            vr = buf[pos + 4:pos + 6]
            if vr in _LONG_VRS:
                length = struct.unpack("<I", buf[pos + 8:pos + 12])[0]
                hdr = 12
            else:
                length = struct.unpack("<H", buf[pos + 6:pos + 8])[0]
                hdr = 8
        else:
            vr = b""
            length = struct.unpack("<I", buf[pos + 4:pos + 8])[0]
            hdr = 8
        body = pos + hdr
        if length == 0xFFFFFFFF:
            if vr == b"SQ" or not explicit:
                pos = _skip_undefined_sq(buf, body)
                continue
            raise ValueError(
                f"undefined-length element ({group:04x},{elem:04x}) — "
                "compressed pixel data is unsupported; convert externally")
        key = _WANTED.get((group, elem))
        if key is not None:
            name, kind = key
            out[name] = _parse_value(kind, buf[body:body + length])
            if name == "PixelData":
                return out
        pos = body + length
    return out


def parse_dicom_file(path: str | Path) -> dict:
    """Parse one DICOM file into the tag subset _WANTED (see module doc for
    the supported transfer syntaxes)."""
    buf = Path(path).read_bytes()
    if buf[128:132] == b"DICM":
        # file meta group (0002,...) is always explicit VR little endian
        pos = 132
        ts = _EXPLICIT_LE
        n = len(buf)
        while pos + 8 <= n:
            group, elem = struct.unpack("<HH", buf[pos:pos + 4])
            if group != 0x0002:
                break
            vr = buf[pos + 4:pos + 6]
            if vr in _LONG_VRS:
                length = struct.unpack("<I", buf[pos + 8:pos + 12])[0]
                hdr = 12
            else:
                length = struct.unpack("<H", buf[pos + 6:pos + 8])[0]
                hdr = 8
            if (group, elem) == (0x0002, 0x0010):
                ts = buf[pos + hdr:pos + hdr + length].decode(
                    "ascii").strip("\x00 ")
            pos += hdr + length
        if ts == _IMPLICIT_LE:
            explicit = False
        elif ts == _EXPLICIT_LE:
            explicit = True
        else:
            raise ValueError(
                f"unsupported DICOM transfer syntax {ts} in {path} — "
                "convert the series externally (e.g. dicom2nifti)")
        return _parse_dataset(buf, pos, explicit)
    # headerless stream: sniff explicit VR by the 5th/6th bytes being VR
    # letters (DICOM PS3.5 does not guarantee a preamble)
    explicit = buf[4:6].isalpha() and buf[4:6].isupper()
    return _parse_dataset(buf, 0, explicit)


def read_dicom_series(series_dir: str | Path):
    """Read an uncompressed single-frame CT series directory into
    (volume_zyx float32|int16, Geometry). Slices are sorted by their position
    along the slice normal (not InstanceNumber, which TCIA sometimes
    scrambles); geometry is LPS like the rest of the io package."""
    series_dir = Path(series_dir)
    files = sorted(p for p in series_dir.iterdir()
                   if p.suffix.lower() in (".dcm", ".ima")
                   or (p.is_file() and not p.suffix))
    if not files:
        raise ValueError(f"no DICOM files in {series_dir}")
    slices = []
    for f in files:
        d = parse_dicom_file(f)
        if "PixelData" not in d:
            continue  # e.g. a DICOMDIR or RTSTRUCT stray file
        if d.get("BitsAllocated", 16) != 16:
            raise ValueError(f"{f}: only 16-bit CT slices supported")
        rows, cols = d["Rows"], d["Columns"]
        dt = np.int16 if d.get("PixelRepresentation", 1) == 1 else np.uint16
        pix = np.frombuffer(d["PixelData"], dtype=np.dtype(dt).newbyteorder("<"),
                            count=rows * cols).reshape(rows, cols)
        slices.append((d, pix))
    if not slices:
        raise ValueError(f"no image slices in {series_dir}")

    d0 = slices[0][0]
    iop = np.asarray(d0["ImageOrientationPatient"], np.float64)
    row_dir, col_dir = iop[:3], iop[3:6]   # along +columns (x), +rows (y)
    normal = np.cross(row_dir, col_dir)
    slices.sort(key=lambda s: float(np.dot(s[0]["ImagePositionPatient"],
                                           normal)))
    positions = np.asarray([s[0]["ImagePositionPatient"] for s in slices])
    zproj = positions @ normal
    dz = float(np.mean(np.diff(zproj))) if len(slices) > 1 else 1.0
    if len(slices) > 2 and not np.allclose(np.diff(zproj), dz, atol=0.01):
        raise ValueError(f"{series_dir}: non-uniform slice spacing "
                         f"({np.diff(zproj).min():.4f}.."
                         f"{np.diff(zproj).max():.4f}); resample externally")
    dr, dc = d0["PixelSpacing"]  # (between rows = y, between cols = x)

    # DICOM allows per-slice RescaleSlope/Intercept; apply each slice's own
    # values (a uniform series — the common CT case — takes the vectorized
    # broadcast below either way)
    slopes = np.asarray([float((s[0].get("RescaleSlope") or [1.0])[0])
                         for s in slices], np.float32)
    inters = np.asarray([float((s[0].get("RescaleIntercept") or [0.0])[0])
                         for s in slices], np.float32)
    vol = np.stack([s[1] for s in slices]).astype(np.float32)
    if np.any(slopes != 1.0):
        vol *= slopes[:, None, None]
    if np.any(inters != 0.0):
        vol += inters[:, None, None]
    if float(vol.min()) >= np.iinfo(np.int16).min and \
            float(vol.max()) <= np.iinfo(np.int16).max and \
            np.all(vol == np.rint(vol)):
        vol = vol.astype(np.int16)  # CT HU fit int16 exactly (dicom2nifti too)

    direction = np.stack([row_dir, col_dir, normal], axis=1)  # columns x,y,z
    geom = Geometry(spacing=(float(dc), float(dr), abs(dz) or 1.0),
                    origin=tuple(float(v) for v in positions[0]),
                    direction=tuple(float(v) for v in direction.reshape(-1)))
    return vol, geom


def dicom_series_to_nifti(series_dir: str | Path, out_path: str | Path) -> None:
    """Convert one series directory to a NIfTI file (the dicom2nifti call in
    Task062_NIHPancreas.py:57, minus its reorientation pass — callers apply
    utils/reorientation.reorient_file_to_ras like the reference's nibabel
    as_closest_canonical step)."""
    vol, geom = read_dicom_series(series_dir)
    write_nifti(out_path, vol, geom)


def _looks_like_dicom(path: Path) -> bool:
    """Same filename predicate read_dicom_series uses (.dcm/.ima), plus a
    DICM-preamble sniff for extensionless files — discovery and reading must
    agree or IMA/extensionless series trees become invisible."""
    suffix = path.suffix.lower()
    if suffix in (".dcm", ".ima"):
        return True
    if suffix or not path.is_file():
        return False
    try:
        with open(path, "rb") as f:
            f.seek(128)
            return f.read(4) == b"DICM"
    except OSError:
        return False


def find_dicom_series_dirs(root: str | Path) -> list[Path]:
    """Leaf directories under a TCIA manifest tree that contain DICOM files
    (the reference walks exactly two levels below each case,
    Task062_NIHPancreas.py:45-53; this accepts any depth)."""
    out = []
    for dirpath, dirnames, filenames in os.walk(root):
        d = Path(dirpath)
        if any(_looks_like_dicom(d / f) for f in filenames):
            out.append(d)
    return sorted(out)


def convert_tcia_dicom_tree(root: str | Path, out_dir: str | Path,
                            num_threads: int = 4) -> list[str]:
    """TCIA manifest root (case/<study>/<series>/*.dcm) -> out_dir/<case>.nii.gz
    for every case directory directly under root. Returns the written paths."""
    from concurrent.futures import ThreadPoolExecutor
    root = Path(root)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = []
    for case in sorted(p for p in root.iterdir() if p.is_dir()):
        series = find_dicom_series_dirs(case)
        if not series:
            continue
        if len(series) > 1:
            # Pancreas-CT has exactly one series per case; pick the largest
            series.sort(key=lambda s: sum(1 for _ in s.iterdir()))
        jobs.append((series[-1], out_dir / (case.name + ".nii.gz")))
    with ThreadPoolExecutor(max_workers=num_threads) as pool:
        list(pool.map(lambda j: dicom_series_to_nifti(*j), jobs))
    return [str(j[1]) for j in jobs]
