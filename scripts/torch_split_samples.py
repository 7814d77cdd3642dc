#!/usr/bin/env python3
"""Stage-4 CLI of the PyTorch port: split HDF5 samples into train/val/test
and write the average-size prior (port of scripts/split_samples.py, same
flags and output line; reference utils/virtualhome/4_split_samples.py).

The split lands in <out>/<level>/{train,val,test,avg_data}.json.  The
port's DatasetConfig reads the prior from
datasets/virtualhome_22_classes/splits/<level>/avg_data.json under the
working directory, so ``--out datasets/virtualhome_22_classes/splits`` puts
it where training and testing find it.  Needs h5py to read the samples.

Usage:
    python3 scripts/torch_split_samples.py --samples <dir> --out <split_root>
        [--level script_level|char_level|room_level] [--seed 2] [--keep-char NAME]
"""

import argparse
import glob
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None):
    parser = argparse.ArgumentParser("Split samples.")
    parser.add_argument("--samples", required=True)
    parser.add_argument("--out", required=True, help="splits root dir")
    parser.add_argument("--level", default="script_level", choices=["script_level", "char_level", "room_level"])
    parser.add_argument("--seed", type=int, default=2)
    parser.add_argument("--keep-char", default=None, help="room_level: keep only this character's samples")
    args = parser.parse_args(argv)

    from pose2room_tpu_torch.datagen import compute_avg_prior, generate_splits

    files = sorted(glob.glob(os.path.join(args.samples, "*.hdf5")))
    split_dir = os.path.join(args.out, args.level)
    split = generate_splits(files, split_dir, level=args.level, seed=args.seed, keep_char=args.keep_char)
    prior = compute_avg_prior(split["train"], split_dir)
    print(
        f"{args.level}: {len(split['train'])} train / {len(split['test'])} test; "
        f"prior classes: {len(prior['obj_size_cls_avg'])}"
    )


if __name__ == "__main__":
    main()
