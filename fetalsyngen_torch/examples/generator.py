"""Walkthrough: the three dataset configurations (port of
``examples/generator.py``, the reference's ``examples/generator.ipynb`` as a
runnable script).

Builds a tiny procedural BIDS tree, then exercises:
1. synthetic generation from seeds (synth_train), with genparams replay,
2. image-as-intensity augmentation (real_train),
3. offline test loading with invertible transforms (testing),
from the repository's YAMLs. Writes NIfTIs under ``--out``.

    python -m fetalsyngen_torch.examples.generator [--shape 64] [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

CONFIGS = Path(__file__).resolve().parents[2] / "configs" / "dataset"


def main(argv=None) -> dict:
    """Run the walkthrough; returns each configuration's item and the
    reversed test item."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", type=int, default=64)
    ap.add_argument("--out", type=str, default="example_out")
    ap.add_argument("--device", type=str, default="cuda", help="generator device (cpu for tests)")
    args = ap.parse_args(argv)

    from ..config import instantiate, load_yaml, resolve_interpolations
    from ..io import nifti
    from ..testing import build_bids_tree

    root = Path(args.out) / "bids"
    root.mkdir(parents=True, exist_ok=True)
    if not (root / "sub-aaa").exists():
        build_bids_tree(root, shape=(args.shape,) * 3)
    out_dir = Path(args.out)

    def dataset_from(name, **overrides):
        cfg = resolve_interpolations(load_yaml(CONFIGS / f"{name}.yaml"))
        cfg["bids_path"] = str(root)
        if cfg.get("seed_path"):
            cfg["seed_path"] = str(root / "derivatives" / "seeds")
        gen_cfg = cfg.pop("generator", None)
        cfg.update(overrides)
        if gen_cfg is not None:
            s = [args.shape] * 3
            gen_cfg["shape"] = s
            gen_cfg["device"] = args.device
            gen_cfg["spatial_deform"]["size"] = s
            gen_cfg["intensity_generator"]["max_subclusters"] = 2
            for k in ("blur_cortex", "struct_noise", "simulate_motion", "boundaries"):
                gen_cfg.pop(k, None)  # keep the walkthrough fast
            return instantiate(cfg, generator=instantiate(gen_cfg))
        transforms = cfg.pop("transforms", None)
        return instantiate(cfg, transforms=instantiate(transforms) if transforms else None)

    # 1. synthetic generation from seeds
    ds = dataset_from("synth_train")
    item = ds.sample_with_meta(0)
    print("[synth_train]", item["name"], item["image"].shape, "gen",
          f"{item['generation_params']['generation_time']:.2f}s")
    nifti.save(out_dir / "synth_image.nii.gz", item["image"][0])
    nifti.save(out_dir / "synth_label.nii.gz", item["label"][0].astype(np.int16))

    # genparams replay: identical volume
    replay = ds.sample_with_meta(0, genparams=item["generation_params"])
    if not (np.array_equal(replay["image"], item["image"]) and np.array_equal(replay["label"], item["label"])):
        raise RuntimeError("genparams replay did not reproduce the sample")
    print("[replay] voxel-identical: True")

    # 2. image-as-intensity (real_train)
    ds_real = dataset_from("real_train")
    item2 = ds_real[0]
    print("[real_train]", item2["name"], item2["image"].shape)
    nifti.save(out_dir / "real_aug_image.nii.gz", item2["image"][0])

    # 3. offline test data with invertible transforms
    cfg = resolve_interpolations(load_yaml(CONFIGS / "testing.yaml"))
    cfg["bids_path"] = str(root)
    tf = instantiate(cfg.pop("transforms"))
    for t in tf.transforms:
        if hasattr(t, "spatial_size"):
            t.spatial_size = (args.shape,) * 3
        if hasattr(t, "roi_size"):
            t.roi_size = (args.shape,) * 3
    ds_test = instantiate(cfg, transforms=tf)
    item3 = ds_test[0]
    rev = ds_test.reverse_transform(dict(item3))
    print("[testing]", item3["image"].shape, "-> reversed", rev["image"].shape)
    print(f"done; outputs in {out_dir}/")
    return {"synth_train": item, "real_train": item2, "testing": item3, "reversed": rev}


if __name__ == "__main__":
    main()
