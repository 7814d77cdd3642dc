#!/usr/bin/env python3
"""Stage-3 CLI of the PyTorch port: VirtualHome recordings -> HDF5 training
samples (port of scripts/generate_samples.py, same flags and output line).

Reads recording/<scene>/<room>/<script>/<char>/.../pd_script.txt and the
stage-1 script_bbox/<scene>/{room_bbox,bbox}_<room>.json beside the
recording root (reference utils/virtualhome/3_generate_samples.py).  Needs
h5py to write the files.

Usage:
    python3 scripts/torch_generate_samples.py --recordings <dir> --out <sample_dir>
        [--no-augment] [--workers 8]
"""

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None):
    parser = argparse.ArgumentParser("Generate HDF5 samples from recordings.")
    parser.add_argument("--recordings", required=True, help="recording root dir")
    parser.add_argument("--out", required=True, help="output samples dir")
    parser.add_argument("--no-augment", action="store_true")
    parser.add_argument("--workers", type=int, default=8)
    args = parser.parse_args(argv)

    from pose2room_tpu_torch.datagen import generate_samples

    written = generate_samples(args.recordings, args.out, augment=not args.no_augment, n_workers=args.workers)
    print(f"wrote {len(written)} samples to {args.out}")


if __name__ == "__main__":
    main()
