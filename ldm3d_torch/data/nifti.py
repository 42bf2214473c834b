"""NIfTI-1 ingest, spatial normalisation and export: the port's own copy
of `ldm3d.data.nifti` (gzip, struct, numpy, and scipy.ndimage for the
resampling).

  - load_nifti: header parse (348-byte NIfTI-1, either byte order),
    scl_slope / scl_inter applied, affine from sform > qform > pixdim.
  - reslice / transform_image: trilinear resample to 1 mm^3, recentre
    into 256^3 through the inverse affine, downscale by 2 to 128^3.
  - transform_brats_image: resample to 2 mm^3, pad or crop to 128^3.
  - get_dataset_list / load_transform_img: the reference's directory
    layout and per-dataset mask and context rules, min-max to [0, 1].
  - nifti_bytes / save_nifti: export. The service's "nii" response is
    `gzip.compress(nifti_bytes(volume))`.
"""

from __future__ import annotations

import glob
import gzip
import os
import struct

import numpy as np

INIT_SHAPE = (256, 256, 256)
FINAL_SHAPE = (128, 128, 128)
SCALE = 2

_DTYPES = {2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32,
           64: np.float64, 256: np.int8, 512: np.uint16, 768: np.uint32}


def _quaternion_affine(hdr) -> np.ndarray:
    b, c, d = hdr["quatern_b"], hdr["quatern_c"], hdr["quatern_d"]
    a = np.sqrt(max(0.0, 1.0 - (b * b + c * c + d * d)))
    qfac = -1.0 if hdr["pixdim"][0] < 0 else 1.0
    R = np.array([
        [a * a + b * b - c * c - d * d, 2 * (b * c - a * d),
         2 * (b * d + a * c)],
        [2 * (b * c + a * d), a * a + c * c - b * b - d * d,
         2 * (c * d - a * b)],
        [2 * (b * d - a * c), 2 * (c * d + a * b),
         a * a + d * d - b * b - c * c],
    ])
    R = R * np.array([hdr["pixdim"][1], hdr["pixdim"][2],
                      qfac * hdr["pixdim"][3]])
    aff = np.eye(4)
    aff[:3, :3] = R
    aff[:3, 3] = [hdr["qoffset_x"], hdr["qoffset_y"], hdr["qoffset_z"]]
    return aff


def load_nifti(path: str, return_voxsize: bool = False):
    """(data float32 [x, y, z], affine [4, 4]) of a .nii / .nii.gz file,
    and the voxel size with `return_voxsize`. Big-endian headers, F-order
    data, scl_slope (0 means no scaling, inter included) and the sform >
    qform > pixdim affine priority, as the JAX package reads them."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        raw = f.read()
    hdr_bytes = raw[:348]
    end = "<"
    if struct.unpack_from("<i", hdr_bytes, 0)[0] != 348:
        if struct.unpack_from(">i", hdr_bytes, 0)[0] == 348:
            end = ">"
        else:
            raise ValueError(f"{path}: not a NIfTI-1 file")
    dim = struct.unpack_from(end + "8h", hdr_bytes, 40)
    datatype = struct.unpack_from(end + "h", hdr_bytes, 70)[0]
    pixdim = struct.unpack_from(end + "8f", hdr_bytes, 76)
    vox_offset = struct.unpack_from(end + "f", hdr_bytes, 108)[0]
    scl_slope = struct.unpack_from(end + "f", hdr_bytes, 112)[0]
    scl_inter = struct.unpack_from(end + "f", hdr_bytes, 116)[0]
    quatern = struct.unpack_from(end + "6f", hdr_bytes, 256)
    srow = np.array(struct.unpack_from(end + "12f", hdr_bytes, 280)
                    ).reshape(3, 4)
    qform_code, sform_code = struct.unpack_from(end + "2h", hdr_bytes, 252)

    shape = tuple(dim[1:1 + max(dim[0], 3)])
    shape = tuple(s for s in shape[:3] if s > 0)
    dtype = _DTYPES.get(datatype)
    if dtype is None:
        raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
    dtype = np.dtype(dtype).newbyteorder(end)
    data = np.frombuffer(raw, dtype=dtype, count=int(np.prod(shape)),
                         offset=int(vox_offset)).reshape(shape, order="F")
    data = np.asarray(data, np.float32)
    if scl_slope != 0.0 and (scl_slope != 1.0 or scl_inter != 0.0):
        data = data * scl_slope + scl_inter

    if sform_code > 0:
        affine = np.eye(4)
        affine[:3, :] = srow
    elif qform_code > 0:
        affine = _quaternion_affine({
            "quatern_b": quatern[0], "quatern_c": quatern[1],
            "quatern_d": quatern[2], "qoffset_x": quatern[3],
            "qoffset_y": quatern[4], "qoffset_z": quatern[5],
            "pixdim": pixdim})
    else:
        affine = np.diag([pixdim[1], pixdim[2], pixdim[3], 1.0])

    if return_voxsize:
        voxsize = tuple(float(abs(p)) for p in pixdim[1:4])
        return data, affine, voxsize
    return data, affine


def reslice(image: np.ndarray, affine: np.ndarray, voxsize, new_voxsize):
    """Trilinear resample to a new voxel size: (image2, affine2)."""
    from scipy import ndimage
    zoom = np.array(voxsize, np.float64) / np.array(new_voxsize, np.float64)
    new_shape = np.round(np.array(image.shape[:3]) * zoom).astype(int)
    out = ndimage.affine_transform(
        image, np.diag(1.0 / zoom), output_shape=tuple(new_shape), order=1)
    affine2 = affine.copy()
    affine2[:3, :3] = affine[:3, :3] @ np.diag(1.0 / zoom)
    return out, affine2


def transform_image(image: np.ndarray, affine: np.ndarray,
                    voxsize=None, scale: int = SCALE):
    """Resample to 1 mm^3, recentre into INIT_SHAPE through the inverse
    affine, downscale by `scale`: (volume, recentred affine)."""
    from scipy import ndimage
    affine2 = affine
    if voxsize is not None:
        image, affine2 = reslice(image, affine, voxsize, (1, 1, 1))
    affine2 = affine2.copy()
    affine2[:3, 3] += np.array([INIT_SHAPE[0] // 2, INIT_SHAPE[1] // 2,
                                INIT_SHAPE[2] // 2])
    out = ndimage.affine_transform(image, np.linalg.inv(affine2),
                                   output_shape=INIT_SHAPE, order=1)
    out, _ = reslice(out, np.eye(4), (1, 1, 1), (scale, scale, scale))
    return out, affine2


def transform_brats_image(image: np.ndarray, affine: np.ndarray, voxsize,
                          final_shape=FINAL_SHAPE):
    """Resample to 2 mm^3, then centre-pad or centre-crop each axis to
    `final_shape`: (volume, affine)."""
    tmp, _ = reslice(image, affine, voxsize, (2, 2, 2))
    pads, slices = [], []
    for i in range(3):
        cur = tmp.shape[i]
        if cur <= final_shape[i]:
            p = (final_shape[i] - cur) // 2
            pads.append((p, final_shape[i] - cur - p))
            slices.append(slice(None))
        else:
            pads.append((0, 0))
            s = (cur - final_shape[i]) // 2
            slices.append(slice(s, s + final_shape[i]))
    return np.pad(tmp[tuple(slices)], pads, mode="constant"), affine


def get_dataset_list(dataset_vers: str, test_run_flag: bool = False,
                     dataset_dir: str = "/data/mri"):
    """The sorted NIfTI paths of a dataset ("CC", "NFBS", "HCP", "BraTS",
    "all" = the first three, "all-T" = all four) under `dataset_dir`, the
    first 24 with `test_run_flag`."""
    j = os.path.join
    patterns = {
        "CC": [j(dataset_dir, "CC359", "Original", "*.nii.gz")],
        "NFBS": [j(dataset_dir, "NFBS_Dataset", "*",
                   "sub-*_ses-NFB3_T1w_brain.nii.gz")],
        "HCP": [j(dataset_dir, "HCP_T1", "T1", "*.nii.gz")],
        "BraTS": [j(dataset_dir, "BraTS2021", "*", "*_t1.nii.gz")],
    }
    patterns["all"] = patterns["CC"] + patterns["NFBS"] + patterns["HCP"]
    patterns["all-T"] = patterns["all"] + patterns["BraTS"]
    files = []
    for p in patterns[dataset_vers]:
        files.extend(sorted(glob.glob(p)))
    if test_run_flag:
        files = files[:24]
    return files


def load_transform_img(path: str):
    """(vol [128^3, 1] float32 in [0, 1], mask [128^3, 1], context int) of
    one file: CC359 times its STAPLE mask and NFBS times its brain mask
    (both then with a zero mask channel, as the reference), BraTS with its
    binarised segmentation as the mask and context 1, anything else a zero
    mask; negative voxels flipped, then min-max."""
    vol, affine, voxsize = load_nifti(path, return_voxsize=True)
    context = 0
    mask = None
    if "CC359" in path:
        mask, _ = load_nifti(path.replace("Original", "STAPLE")
                             .replace(".nii.gz", "_staple.nii.gz"))
        vol = vol * mask
    elif "NFBS" in path:
        mask, _ = load_nifti(path[:-7] + "mask.nii.gz")
        vol = vol * mask
    elif "BraTS2021" in path:
        vol = vol.astype(np.float32)
        mask, _ = load_nifti(path.replace("t1.nii.gz", "seg.nii.gz"))
        mask = mask.astype(np.float32)
        context = 1

    if "BraTS2021" in path:
        if mask is not None:
            mask, _ = transform_brats_image(mask, affine, voxsize)
            mask[mask < 0] *= -1
            mask[mask >= 1] = 1
        vol, _ = transform_brats_image(vol, affine, voxsize)
    else:
        vol, _ = transform_image(vol, affine, voxsize)
        mask = np.zeros_like(vol)

    vol[vol < 0] *= -1
    vmin, vmax = vol.min(), vol.max()
    vol = (vol - vmin) / max(vmax - vmin, 1e-12)
    return (vol[..., None].astype(np.float32),
            mask[..., None].astype(np.float32), int(context))


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
