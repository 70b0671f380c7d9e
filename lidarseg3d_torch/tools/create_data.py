"""Dataset info files for the port (the port's counterpart of
tools/create_data.py).

    python -m lidarseg3d_torch.tools.create_data semanticnusc --root R
        [--version v1.0-trainval] [--nsweeps 1] [--cams] [--out_dir D]
    python -m lidarseg3d_torch.tools.create_data semanticwaymo --root R
        [--split training] [--nsweeps 1] [--out_dir D]
    python -m lidarseg3d_torch.tools.create_data {semanticnusc,
        semantickitti, semanticwaymo} --root R --dry-data [--version V]
        [--cams] [--split S]

``semanticnusc`` writes ``infos_train_NNsweeps_segdet.pkl`` and
``infos_val_NNsweeps_segdet.pkl`` into ``--out_dir`` (the root by
default) through ``datasets.nuscenes.create_nuscenes_seg_infos``;
``--cams`` adds the six cameras' calibration and image paths (MSeg3D).
``--dry-data`` validates the tree (``datasets/validate.py``) and writes
nothing; SemanticKITTI needs no info files, so it takes ``--dry-data``
only (``--cams`` then checks its camera frames). ``semanticwaymo``
converts ``R/SPLIT/*.tfrecord`` into frame pkls, camera JPEGs and
``infos_SPLIT_NNsweeps_segdet.pkl`` through
``datasets.waymo.converter.create_semanticwaymo_infos``, which needs
tensorflow and waymo_open_dataset (it raises ImportError without them);
its ``--dry-data`` checks the split's tfrecords.

    python -m lidarseg3d_torch.tools.create_data waymo_gt_database --root R
        [--nsweeps 1] [--out_dir D]

writes detection's ground-truth database from the converted training
frames (``R/infos_train_NNsweeps_segdet.pkl``): each VEHICLE, PEDESTRIAN
and CYCLIST box's points (at least 5) as ``D/gt_database/CLASS_I.bin`` and
``D/dbinfos_train.pkl``, which the Waymo detection configs' ``db_sampler``
reads (``datasets.pipelines.det_pipeline.create_gt_database``).
"""

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Dataset info files")
    p.add_argument("dataset", choices=["semanticnusc", "semantickitti",
                                       "semanticwaymo", "waymo_gt_database"])
    p.add_argument("--root", required=True)
    p.add_argument("--version", default="v1.0-trainval")
    p.add_argument("--nsweeps", type=int, default=1)
    p.add_argument("--cams", action="store_true",
                   help="include the six cameras' calibration and paths")
    p.add_argument("--out_dir", default=None)
    p.add_argument("--dry-data", action="store_true",
                   help="validate the mounted raw tree and exit")
    p.add_argument("--split", default="training",
                   help="the Waymo tfrecord split directory")
    return p.parse_args(argv)


def main(argv=None):
    """Run the tool; returns the summary of ``--dry-data`` or the paths
    of the info files written."""
    args = parse_args(argv)
    if args.dataset == "waymo_gt_database":
        return [waymo_gt_database(args.root, args.nsweeps, args.out_dir)]
    if args.dataset == "semantickitti" and not args.dry_data:
        raise SystemExit("semantickitti reads raw sequences (no info "
                         "files); only --dry-data applies")
    if args.dry_data:
        from ..datasets import validate

        if args.dataset == "semantickitti":
            rep = validate.validate_semantickitti(args.root,
                                                  use_img=args.cams)
        elif args.dataset == "semanticwaymo":
            rep = validate.validate_semanticwaymo(args.root,
                                                  split=args.split)
        else:
            rep = validate.validate_semanticnusc(args.root,
                                                 version=args.version)
        print(f"dry-data OK: {rep}")
        return rep
    if args.dataset == "semanticwaymo":
        from ..datasets.waymo.converter import create_semanticwaymo_infos

        path = create_semanticwaymo_infos(args.root, out_dir=args.out_dir,
                                          nsweeps=args.nsweeps,
                                          split=args.split)
        print(f"wrote {path}")
        return [path]
    from ..datasets.nuscenes.common import create_nuscenes_seg_infos
    from ..datasets.nuscenes.metadata import CAM_CHANS

    paths = create_nuscenes_seg_infos(
        args.root, version=args.version, nsweeps=args.nsweeps,
        cam_chans=CAM_CHANS if args.cams else None, out_dir=args.out_dir)
    print("\n".join(f"wrote {p}" for p in paths))
    return paths


def waymo_gt_database(root, nsweeps=1, out_dir=None):
    """The Waymo detection gt database (module docstring) -> the path of
    dbinfos_train.pkl."""
    import os

    from ..datasets import build_dataset
    from ..datasets.pipelines.det_pipeline import create_gt_database

    ds = build_dataset(dict(
        type="SemanticWaymoDataset", root_path=root,
        info_path=os.path.join(root,
                               f"infos_train_{nsweeps:02d}sweeps_segdet.pkl"),
        pipeline=[dict(type="LoadPointCloudFromFile",
                       dataset="SemanticWaymoDataset"),
                  dict(type="LoadDetAnnotations")]))
    db = create_gt_database(ds, out_dir or root,
                            class_names=["VEHICLE", "PEDESTRIAN", "CYCLIST"],
                            min_points=5)
    print(f"wrote {db}")
    return db


if __name__ == "__main__":
    main()
