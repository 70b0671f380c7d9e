"""The port's multi-process runtime against the JAX package's (held on the
CPU, gloo ranks spawned by tests/_torch_ddp.py):

- ``EpochSampler``'s per-host shards and ``steps_per_epoch`` equal the
  JAX package's sampler exactly, over frame counts that do and do not
  divide by the hosts (n = 7 on 2 and 3 hosts among them), shuffle and
  drop_last on and off, three epochs; ``owned`` marks each frame on
  exactly one host (without drop_last);
- ``parallel/dist.py`` on 2 ranks: ``is_main_process``, ``barrier``,
  ``allreduce_hist`` (a sum), the differentiable ``all_reduce_sum`` and
  ``gather_rows`` (their backward a sum over the ranks), ``local_rows``,
  ``global_ratio`` and ``gather_to_main``;
- ``init_distributed`` reads torchrun's variables in one process, no
  group started: ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` give the rank
  and size, ``MASTER_ADDR`` / ``MASTER_PORT`` the ``tcp://host:port``
  rendezvous (port 29500 when ``MASTER_PORT`` is unset), and a flag's
  coordinator takes the place of the two;
- the JAX package counts a frame twice when it pads the eval shards:
  its sampler's two shards of three frames both hold frame 0, and its
  ``evaluation`` of each shard's detections, summed as ``allreduce_hist``
  sums them across processes, counts frame 0's points twice (ROADMAP §C,
  reference fault 12). The port's shards mark the repeat as not owned."""

import numpy as np
import pytest
import torch

from lidarseg3d_tpu.datasets.loader import EpochSampler as JSampler
from lidarseg3d_torch.datasets.loader import EpochSampler

from _torch_ddp import collectives, run_ranks

CASES = [(n, hosts) for n in (1, 2, 7, 9, 10) for hosts in (1, 2, 3)]


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("n,hosts", CASES)
def test_sharded_sampler_equals_jax(n, hosts, shuffle, drop_last):
    for bs in (1, 2, 3):
        seen = []
        for host in range(hosts):
            kw = dict(shuffle=shuffle, seed=5, num_hosts=hosts, host_id=host,
                      drop_last=drop_last)
            got, want = EpochSampler(n, bs, **kw), JSampler(n, bs, **kw)
            assert got.steps_per_epoch() == want.steps_per_epoch()
            for epoch in range(3):
                idx = got.epoch_indices(epoch)
                np.testing.assert_array_equal(idx, want.epoch_indices(epoch))
                if n >= hosts - 1:  # else the padding, idx[:pad], is
                    # shorter than pad and the shards differ in length, in
                    # both packages
                    assert idx.shape == (got.steps_per_epoch(), bs)
                owned = got.owned(epoch)
                assert owned.shape == idx.shape
                if epoch == 0:
                    seen.extend(idx[owned].tolist())
        if not drop_last:  # every frame owned by exactly one host
            assert sorted(seen) == list(range(n)), (bs, seen)


def test_collectives_on_two_ranks(tmp_path):
    r0, r1 = run_ranks(collectives, 2, tmp_path)
    assert (r0["rank"], r0["world"], r0["main"]) == (0, 2, True)
    assert (r1["rank"], r1["world"], r1["main"]) == (1, 2, False)
    for r in (r0, r1):
        np.testing.assert_array_equal(r["hist"], np.full((3, 3), 3))
        # y = x0 + 2 x1 on both ranks; rank q's loss weighs y by q + 1, so
        # dL/dx_r = (r + 1) * (1 + 2)
        torch.testing.assert_close(r["sum"], 3 * torch.arange(4.0))
        torch.testing.assert_close(r["gathered"], torch.tensor(
            [[0.0] * 3] * 2 + [[1.0] * 3] * 2))
    torch.testing.assert_close(r0["sum_grad"], torch.full((4,), 3.0))
    torch.testing.assert_close(r1["sum_grad"], torch.full((4,), 6.0))
    # each rank's loss weighs gathered row i by i + 1; both losses reach
    # each rank's rows
    torch.testing.assert_close(r0["gather_grad"], torch.tensor(
        [[2.0] * 3, [4.0] * 3]))
    torch.testing.assert_close(r1["gather_grad"], torch.tensor(
        [[6.0] * 3, [8.0] * 3]))
    assert r0["local"].tolist() == [0, 1] and r1["local"].tolist() == [2, 3]
    for r in (r0, r1):
        assert float(r["ratio"]) == 3.0  # (1 + 2) / max(0 + 1, 1)
    assert r0["gather_main"] == [{"r": 0}, {"r": 1}]
    assert r1["gather_main"] is None


@pytest.mark.parametrize("port", ["12345", None])
def test_torchrun_variables_resolve_to_a_tcp_url(monkeypatch, port):
    from lidarseg3d_torch.parallel import dist

    calls = []
    monkeypatch.setattr(dist.tdist, "init_process_group",
                        lambda *a, **k: calls.append((a, k)))
    env = dict(RANK="1", WORLD_SIZE="2", LOCAL_RANK="1",
               MASTER_ADDR="localhost")
    if port is not None:
        env["MASTER_PORT"] = port
    else:
        monkeypatch.delenv("MASTER_PORT", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert dist.init_distributed(device="cpu") == (1, 2)
    assert dist.init_distributed("file:///x/rendezvous", device="cpu") == (
        1, 2)
    url = f"tcp://localhost:{port or 29500}"
    assert calls == [
        (("gloo",), dict(init_method=url, world_size=2, rank=1)),
        (("gloo",), dict(init_method="file:///x/rendezvous", world_size=2,
                         rank=1))]
    assert not dist.active()


def test_jax_eval_padding_counts_a_frame_twice(tmp_path, monkeypatch):
    """Three frames on two processes: the JAX sampler pads the shards to
    two frames each by repeating frame 0, each process's run_eval keys its
    detections by token, and the summed histograms count frame 0 twice."""
    import lidarseg3d_tpu.parallel.dist as jdist
    from lidarseg3d_tpu.datasets import build_dataset as jbuild_dataset
    from lidarseg3d_torch.synthetic import write_semantickitti_tree

    from test_torch_port_support import mini_val_dataset_cfg

    root = str(tmp_path / "sequences")
    write_semantickitti_tree(root, ("00",), frames=3, points=(300, 400),
                             seed=3, image_hw=(32, 64), max_range=6.0)
    ds = jbuild_dataset(mini_val_dataset_cfg(root))
    shards = [JSampler(3, 1, shuffle=False, num_hosts=2, host_id=h,
                       drop_last=False).epoch_indices(0).ravel()
              for h in (0, 1)]
    assert [s.tolist() for s in shards] == [[0, 2], [1, 0]]
    hists = []
    monkeypatch.setattr(jdist, "allreduce_hist",
                        lambda h: hists.append(np.asarray(h)) or h)
    tokens = [ds.get_sensor_data(i)["metadata"]["token"] for i in range(3)]
    npts = []
    for i in range(3):  # predict each point's label: every point counts
        gt = ds.get_anno_for_eval(tokens[i])["point_sem_labels"]
        npts.append(int((gt != 0).sum()))
    for shard in shards:
        dets = {tokens[i]: {"pred_point_sem_labels":
                            ds.get_anno_for_eval(tokens[i])[
                                "point_sem_labels"]} for i in shard}
        ds.evaluation(dets)
    summed = hists[0] + hists[1]  # what allreduce_hist gives each process
    assert int(summed.sum()) == sum(npts) + npts[0]
    owned = [EpochSampler(3, 1, shuffle=False, num_hosts=2, host_id=h,
                          drop_last=False).owned(0).ravel() for h in (0, 1)]
    assert [o.tolist() for o in owned] == [[True, True], [True, False]]
