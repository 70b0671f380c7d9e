"""The rank function of tests/test_torch_port_waymo.py's multi-process
evaluation (a module without JAX, importable by a spawned rank)."""


def waymo_eval_rank(rank, world, info_path, root, dets):
    """The port's SemanticWaymoDataset ``evaluation`` of this rank's
    shard of ``dets`` (the frames the sharded sampler gives it and owns:
    a padding repeat is dropped), its histogram summed over the ranks."""
    from lidarseg3d_torch.datasets import EpochSampler, build_dataset

    ds = build_dataset(dict(type="SemanticWaymoDataset",
                            info_path=info_path, root_path=root,
                            pipeline=[], test_mode=True))
    sampler = EpochSampler(len(ds), 1, shuffle=False, num_hosts=world,
                           host_id=rank, drop_last=False)
    idx = sampler.epoch_indices(0).ravel()
    owned = sampler.owned(0).ravel()
    tokens = [ds._infos[i]["token"] for i, o in zip(idx, owned) if o]
    res, _ = ds.evaluation({t: dets[t] for t in tokens})
    return dict(tokens=tokens, results=res["results"])
