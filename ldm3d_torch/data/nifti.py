"""NIfTI-1 export of generated volumes: the port's own copy of
`ldm3d.data.nifti.save_nifti` (gzip, struct and numpy only).

`nifti_bytes` builds the uncompressed file; `save_nifti` writes it to a
path, gzipped when the path ends in ".gz". The service's "nii" response
is `gzip.compress(nifti_bytes(volume))`.
"""

from __future__ import annotations

import gzip
import struct

import numpy as np


def nifti_bytes(image: np.ndarray, affine: np.ndarray | None = None,
                voxsize=(1.0, 1.0, 1.0)) -> bytes:
    """A [H, W, D] (or [H, W, D, 1]) float volume as a NIfTI-1 file: the
    348-byte header, a 4-byte extension flag, then float32 data stored
    x-fastest."""
    img = np.asarray(image, np.float32)
    if img.ndim == 4 and img.shape[-1] == 1:
        img = img[..., 0]
    if img.ndim != 3:
        raise ValueError(f"expected a 3D volume, got shape {image.shape}")
    if affine is None:
        affine = np.diag(list(voxsize) + [1.0]).astype(np.float64)

    hdr = bytearray(352)  # 348-byte header + 4-byte extension flag
    struct.pack_into("<i", hdr, 0, 348)                       # sizeof_hdr
    dims = (3,) + img.shape + (1, 1, 1, 1)
    struct.pack_into("<8h", hdr, 40, *dims)                   # dim
    struct.pack_into("<h", hdr, 70, 16)                       # datatype f32
    struct.pack_into("<h", hdr, 72, 32)                       # bitpix
    pix = (1.0,) + tuple(float(np.linalg.norm(affine[:3, i]))
                         for i in range(3)) + (0.0, 0.0, 0.0, 0.0)
    struct.pack_into("<8f", hdr, 76, *pix)                    # pixdim
    struct.pack_into("<f", hdr, 108, 352.0)                   # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)                     # scl_slope
    struct.pack_into("<h", hdr, 252, 1)                       # sform_code
    struct.pack_into("<4f", hdr, 280, *affine[0])             # srow_x
    struct.pack_into("<4f", hdr, 296, *affine[1])             # srow_y
    struct.pack_into("<4f", hdr, 312, *affine[2])             # srow_z
    hdr[344:348] = b"n+1\x00"                                 # magic

    # NIfTI data is stored x-fastest; numpy C-order [H, W, D] must be
    # transposed so viewers read the axes correctly.
    return bytes(hdr) + np.ascontiguousarray(
        img.transpose(2, 1, 0), np.float32).tobytes()


def save_nifti(path: str, image: np.ndarray,
               affine: np.ndarray | None = None,
               voxsize=(1.0, 1.0, 1.0)) -> str:
    """Write `nifti_bytes(image, affine, voxsize)` to `path` (.nii or
    .nii.gz) and return the path."""
    payload = nifti_bytes(image, affine, voxsize)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(payload)
    return path
