"""Resample a BIDS tree to isotropic resolution and crop/pad to a target size
(port of ``fetalsyngen_tpu.scripts.resample``; host only).

Reference parity with the upstream ``scripts/resample.py``: 0.5 mm
``Spacingd`` (bilinear image / nearest label), RAS orientation, center
crop + pad to 256^3, with the port's host transforms instead of MONAI.

    python -m fetalsyngen_torch.scripts.resample --bids_path <in> --out_path <out>
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..data.transforms import CenterSpatialCropd, Compose, Orientationd, SpatialPadd, Spacingd
from ..io import nifti


def main(argv=None):
    ap = argparse.ArgumentParser(description="Resample + crop/pad a BIDS tree")
    ap.add_argument("--bids_path", type=str, required=True)
    ap.add_argument("--out_path", type=str, required=True)
    ap.add_argument("--res", type=float, default=0.5)
    ap.add_argument("--target_size", type=int, nargs=3, default=(256, 256, 256))
    ap.add_argument("--image_pattern", type=str, default="*_T2w.nii.gz")
    ap.add_argument("--label_pattern", type=str, default="*_dseg.nii.gz")
    args = ap.parse_args(argv)

    tf = Compose(
        transforms=[
            Spacingd(pixdim=(args.res,) * 3, mode=("bilinear", "nearest")),
            Orientationd(),
            CenterSpatialCropd(roi_size=args.target_size),
            SpatialPadd(spatial_size=args.target_size),
        ]
    )

    bids_path = Path(args.bids_path)
    out_path = Path(args.out_path)
    subjects = sorted(bids_path.glob("sub-*"))
    print(f"Found {len(subjects)} in {bids_path}")
    res_affine = np.diag([args.res, args.res, args.res, 1.0])

    for sub in subjects:
        anats = sorted(set(p.parent for p in sub.glob("**/anat")))
        for anat in [a for a in sub.glob("**/anat") if a.is_dir()] or anats:
            try:
                imgs = sorted(anat.glob(args.image_pattern))
                labels = sorted(anat.glob(args.label_pattern))
                if not imgs:
                    continue
                img = nifti.load(imgs[0])
                data = {"image": img.data[None].astype(np.float32), "image_affine": img.affine}
                if labels:
                    lab = nifti.load(labels[0])
                    data["label"] = lab.data[None].astype(np.float32)
                    data["label_affine"] = lab.affine
                data = tf(data)
                rel = anat.relative_to(bids_path)
                out_dir = out_path / rel
                out_dir.mkdir(parents=True, exist_ok=True)
                nifti.save(out_dir / imgs[0].name, data["image"][0], res_affine)
                if labels:
                    nifti.save(
                        out_dir / labels[0].name,
                        np.round(data["label"][0]).astype(np.int16),
                        res_affine,
                    )
                print(f"done {rel}")
            except Exception as e:  # keep batch robust like the reference
                print(f"Error processing {anat}: {e}")


if __name__ == "__main__":
    main()
