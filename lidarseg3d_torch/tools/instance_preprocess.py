"""The SemanticKITTI panoptic instance library (the port's counterpart of
tools/instance_preprocess.py): every thing-class instance of at least
``--min_points`` points of the train sequences, cut out under
``OUT/instances_in_sequences`` with the library ``OUT/instance_path.pkl``
that the ``SegInstanceAug`` train transform reads.

    python -m lidarseg3d_torch.tools.instance_preprocess
        --data_path DATA/sequences --out_path DATA [--min_points 10]
"""

import argparse

TRAIN_SEQ = ["00", "01", "02", "03", "04", "05", "06", "07", "09", "10"]


def main(argv=None):
    """-> the library's path."""
    from ..datasets.semantickitti.dataset import SemanticKITTIDataset

    p = argparse.ArgumentParser()
    p.add_argument("--data_path", required=True,
                   help="SemanticKITTI sequences root")
    p.add_argument("--out_path", required=True)
    p.add_argument("--min_points", type=int, default=10)
    args = p.parse_args(argv)
    ds = SemanticKITTIDataset(root_path=args.data_path, sequences=TRAIN_SEQ,
                              test_mode=False)
    pkl = ds.save_instance(args.out_path, min_points=args.min_points)
    print(f"instance library written: {pkl}")
    return pkl


if __name__ == "__main__":
    main()
