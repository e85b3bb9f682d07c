"""Pack or unpack a preprocessed LIDC data set (npy <-> compressed npz).

Counterpart of ``experiments/lidc_exp/pack_dataset.py``: packing shrinks the
data set for a transfer to a cluster; the loader reads unpacked ``.npy``
(``--data_dest`` staging unpacks ``.npz`` archives itself).

    python -m medicaldetectiontoolkit_torch.experiments.lidc_exp.pack_dataset --mode pack --dir PP_DIR
    python -m medicaldetectiontoolkit_torch.experiments.lidc_exp.pack_dataset --mode unpack --dir PP_DIR
    python -m medicaldetectiontoolkit_torch.experiments.lidc_exp.pack_dataset --mode clean_npy --dir PP_DIR
"""

import argparse

from medicaldetectiontoolkit_torch.data.dataloader_utils import delete_npy, pack_dataset, unpack_dataset


def main(argv=None):
    ap = argparse.ArgumentParser(description="pack or unpack a preprocessed data set")
    ap.add_argument("--mode", choices=["pack", "unpack", "clean_npy"], required=True)
    ap.add_argument("--dir", required=True)
    ap.add_argument("--threads", type=int, default=8)
    args = ap.parse_args(argv)
    if args.mode == "pack":
        pack_dataset(args.dir, threads=args.threads)
    elif args.mode == "unpack":
        unpack_dataset(args.dir, threads=args.threads)
    else:
        delete_npy(args.dir)


if __name__ == "__main__":
    main()
