"""Generate intensity seeds for FetalSynthGen (offline preprocessing; port of
``fetalsyngen_tpu.scripts.generate_seeds``).

Fuse segmentation labels into meta-labels (feta/dhcp maps), derive the skull
class from nonzero-image voxels outside the segmentation, EM-cluster each
meta-label's intensities into N subclusters (a Gaussian mixture from
k-means++ inits, :mod:`.gmm`, its EM on the device), and write one int8
NIfTI per (n_subclasses, meta-label), the JAX script's tree and file names.

One process runs the subjects in turn, their fits on the device (CUDA does
not survive ``fork``, so there is no process pool); ``--workers`` host
threads decode the next subject and write the seeds through
``nifti.save_batch`` meanwhile. The fits draw from numpy's global
``RandomState``, fresh each run, as the JAX script's do.

    python -m fetalsyngen_torch.scripts.generate_seeds --bids_path ./data \\
        --out_path ./data/derivatives/seeds --max_subclasses 6 --annotation feta [--device cpu]
"""

from __future__ import annotations

import argparse
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from ..io import nifti
from . import gmm

# segmentation label -> meta-label maps (reference generate_seeds.py:64-85)
FETA2META = {1: 1, 4: 1, 2: 2, 6: 2, 5: 3, 7: 3, 3: 3}
DHCP2META = {1: 1, 5: 1, 2: 2, 7: 2, 9: 2, 3: 3, 6: 3, 8: 3}


def subsplit_label(img: np.ndarray, mask: np.ndarray, label2assign: int, n_clusters: int, *,
                   device="cuda", random_state=None):
    """EM-cluster masked intensities into ``n_clusters`` labels from
    ``label2assign`` on (reference ``subsplit_label``, :177-187)."""
    out = np.zeros(mask.shape, dtype=np.int16)
    voxels = img[mask > 0]
    if voxels.size < n_clusters:
        out[mask > 0] = label2assign
        return out
    clust = gmm.fit_predict(voxels, n_clusters, random_state=random_state, device=device).labels
    out[mask > 0] = clust.cpu().numpy() + label2assign
    return out


def split_labels(image: np.ndarray, segmentation: np.ndarray, subclasses: int, label_map: dict, *,
                 device="cuda", random_state=None):
    """Fuse to meta-labels + skull, then subsplit (reference :190-211)."""
    meta = np.zeros(segmentation.shape, dtype=np.int16)
    for seg_lab, meta_lab in label_map.items():
        meta[segmentation == seg_lab] = meta_lab
    # skull: nonzero image outside the segmentation (generate_seeds.py:197)
    meta[(segmentation == 0) & (image != 0)] = 4

    if subclasses == 1:
        return {m: ((meta == m) * m * 10).astype(np.int8) for m in range(1, 5)}
    return {
        m: subsplit_label(image, meta == m, 10 * m, subclasses, device=device,
                          random_state=random_state).astype(np.int8)
        for m in range(1, 5)
    }


def load_subject(img_path, seg_path, annotation: str):
    """A subject's T2w (float32) and segmentation (int32; the dhcp map drops
    label 4) and the segmentation's affine. The volumes are C-ordered: the
    masks of :func:`split_labels` index in C order, which is 2-3x slower
    over the decoder's Fortran-ordered arrays."""
    img = nifti.load(img_path)
    seg = nifti.load(seg_path)
    image = np.ascontiguousarray(np.nan_to_num(np.asarray(img.data, dtype=np.float32)))
    segm = np.ascontiguousarray(np.nan_to_num(np.asarray(seg.data, dtype=np.float32)).astype(np.int32))
    if annotation == "dhcp":
        segm[segm == 4] = 0
    return image, segm, seg.affine


def seed_outputs(task, volumes, device="cuda", random_state=None):
    """The four seed files of one (subject, subclasses) task: their paths
    (directories made), int8 volumes and affines."""
    _, seg_path, subclasses, label_map, out_path, sub_name, session, _ = task
    image, segm, affine = volumes
    splits = split_labels(image, segm, subclasses, label_map, device=device, random_state=random_state)
    stem = Path(seg_path).name.replace(".nii.gz", "").replace(".nii", "")
    anat = "anat" if not session else f"{session}/anat"
    out_dir = Path(out_path) / f"subclasses_{subclasses}" / sub_name / anat
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = [out_dir / f"{stem}_mlabel_{m}.nii.gz" for m in splits]
    return paths, list(splits.values()), [affine] * len(splits)


def process_subject(task, device="cuda", random_state=None):
    """One (subject, subclasses) task of the JAX script: decode, split and
    write its four seeds."""
    img_path, seg_path, *_, annotation = task
    nifti.save_batch(*seed_outputs(task, load_subject(img_path, seg_path, annotation), device, random_state))
    return task[5], task[2]


def main(argv=None):
    ap = argparse.ArgumentParser(description="Generate seeds for FetalSynthGen")
    ap.add_argument("--bids_path", type=str, required=True)
    ap.add_argument("--out_path", type=str, required=True)
    ap.add_argument("--max_subclasses", type=int, default=10)
    ap.add_argument("--annotation", type=str, required=True, choices=["feta", "dhcp"])
    ap.add_argument("--workers", type=int, default=os.cpu_count(),
                    help="host threads that decode the next subject and write seeds")
    ap.add_argument("--device", type=str, default="cuda", help="where the EM runs (cpu for tests)")
    args = ap.parse_args(argv)
    gmm.resolve_device(args.device)

    label_map = FETA2META if args.annotation == "feta" else DHCP2META
    bids_path = Path(args.bids_path).absolute()
    subjects = sorted(bids_path.glob("sub-*"))
    print(f"Found {len(subjects)} subjects in {bids_path}")

    inputs = []
    for sub in subjects:
        imgs = sorted(sub.glob("**/anat/*_T2w.nii.gz"))
        labels = sorted(sub.glob("**/anat/*_dseg.nii.gz"))
        if not imgs or not labels:
            print(f"skipping {sub.name}: missing T2w or dseg")
            continue
        inputs.append((str(imgs[0]), str(labels[0]), sub.name))

    n_tasks, done = len(inputs) * args.max_subclasses, 0
    with ThreadPoolExecutor(max_workers=max(1, args.workers)) as pool:
        nxt = pool.submit(load_subject, *inputs[0][:2], args.annotation) if inputs else None
        for i, (img_path, seg_path, name) in enumerate(inputs):
            volumes = nxt.result()
            if i + 1 < len(inputs):
                nxt = pool.submit(load_subject, *inputs[i + 1][:2], args.annotation)
            writes = []
            for subclasses in range(1, args.max_subclasses + 1):
                task = (img_path, seg_path, subclasses, label_map, str(args.out_path), name, "",
                        args.annotation)
                writes.append(pool.submit(nifti.save_batch, *seed_outputs(task, volumes, args.device)))
                done += 1
                print(f"[{done}/{n_tasks}] {name} subclasses={subclasses}")
            for w in writes:
                w.result()


if __name__ == "__main__":
    main()
