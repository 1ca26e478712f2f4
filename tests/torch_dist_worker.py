"""One process of a gloo world that tests/test_torch_distributed.py spawns
(``parallel.dryrun.spawn_world``).

    python tests/torch_dist_worker.py MODE SPEC RANK WORLD PORT OUT

MODE "checks" joins the world through ``parallel.mesh.init_distributed``
on the CPU and runs every check of the spec file SPEC (written by the
test: configurations, global batches, the BA problem) on this rank's part:
the training steps on its rows (and a NaN in rank 1's rows only),
the d2d filter's saliency, ``mesh.all_reduce_sum`` and its gradient,
``comm``'s gathers with unequal payloads,
``sfm.pipeline.match_pairs``'s partition and merge, ``gather_metrics`` with
a pair seen on both ranks, the logger's level and the landmark-sharded BA.
MODE "train" runs ``cli.train.main`` with ``--dist-coordinator``, recording
the first loss, the writes and the training scenes.  Each rank saves its
results to OUT/rank{RANK}.pt.  Imports torch and the port only.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from casmtr_tpu_torch.parallel import dryrun  # noqa: E402

torch.set_num_threads(1)


def train_step(spec, rows, nan_rows=None):
    """One step of the spec's model on ``rows``; with ``nan_rows`` a second
    step on them, whose scalars and whether it kept every parameter and
    buffer are added."""
    from casmtr_tpu_torch.config import override
    from casmtr_tpu_torch.configs import build_config
    from casmtr_tpu_torch.models import build_model
    from casmtr_tpu_torch.train.train_step import (init_train_state,
                                                   make_train_step)
    from casmtr_tpu_torch.weights import init_random_
    cfg = override(build_config("outdoor_casmtr_4c"), spec["overrides"])
    model = build_model(cfg.loftr)
    init_random_(model, torch.Generator().manual_seed(spec["seed"]))
    state, tx = init_train_state(model, cfg, 100, spec["lr"], device="cpu")
    step = make_train_step(model, cfg, tx, device="cpu")
    state, scalars = step(state, rows)
    out = dryrun.step_result(model, scalars)
    if nan_rows is not None:
        before = [t.clone() for t in model.state_dict().values()]
        _, nan_scalars = step(state, nan_rows)
        out["nan"] = ({k: float(v) for k, v in nan_scalars.items()},
                      all(torch.equal(a, b) for a, b in
                          zip(before, model.state_dict().values())))
    return out


def fake_match(i, j):
    """A deterministic per-pair output, the same on any rank."""
    n = 3 + (i + j) % 4
    mk = np.full((n, 2), float(i * 100 + j), np.float32)
    return mk, mk + 1.0, np.ones(n, np.float32)


def sharded_ba(problem, rank, world, runs):
    """The landmark-sharded BA on this rank's half of the point-major
    observations (every observation of a landmark on one rank)."""
    from casmtr_tpu_torch.parallel import mesh
    from casmtr_tpu_torch.sfm import ba
    p = ba.BAProblem(**{k: torch.from_numpy(v) for k, v in problem.items()})
    order = torch.argsort(p.obs_pt, stable=True)
    n = p.obs_pt.shape[0] // world
    mine = order[rank * n:(rank + 1) * n]
    local = p._replace(obs_cam=p.obs_cam[mine], obs_pt=p.obs_pt[mine],
                       obs_uv=p.obs_uv[mine], obs_valid=p.obs_valid[mine])
    out = {}
    for name, kw in runs.items():
        q, cost = ba.run_ba(local, group=mesh.group(), **kw)
        out[name] = {"cam_rvec": q.cam_rvec, "cam_tvec": q.cam_tvec,
                     "cost": float(cost),
                     "pts": sorted(set(local.obs_pt.tolist()))}
    return out


def checks(spec, rank, world, port):
    from casmtr_tpu_torch.parallel import comm, mesh
    from casmtr_tpu_torch.sfm import pipeline
    from casmtr_tpu_torch.utils.logging import get_logger
    from casmtr_tpu_torch.utils.metrics import gather_metrics
    mesh.init_distributed(f"localhost:{port}", world, rank, "cpu")
    res = {"world": mesh.world_size(), "rank": mesh.rank(),
           "log_level": get_logger("casmtr_tpu_torch.dist_test").level}
    res["steps"] = {name: train_step(s, mesh.shard_rows(s["batch"]))
                    for name, s in spec["steps"].items()}
    s4 = spec["steps"]["4c"]
    res["nan_step"] = train_step(s4, mesh.shard_rows(s4["batch"]),
                                 mesh.shard_rows(spec["nan_batch"]))["nan"]
    from casmtr_tpu_torch.ops import nms
    with mesh.global_batch():
        res["d2d"] = nms.d2d_saliency(mesh.shard_rows(spec["d2d"])["feat"],
                                      (16, 16))
    x = torch.tensor([rank + 1.0], requires_grad=True)
    y = mesh.all_reduce_sum(x)
    (y * (rank + 1.0)).sum().backward()
    res["all_reduce_sum"] = (y.item(), x.grad.item())
    objs = comm.all_gather({"rank": rank, "blob": "x" * (7 + 137 * rank)})
    res["comm"] = {
        "obj_ranks": [o["rank"] for o in objs],
        "obj_lens": [len(o["blob"]) for o in objs],
        "gather0_len": len(comm.gather({"r": rank}, dst=0)),
        "reduce_mean": comm.reduce_dict({"a": float(rank), "b": 2.0}),
        "reduce_sum": comm.reduce_dict({"a": float(rank)}, average=False),
        "arrays": comm.all_gather_arrays(
            np.asarray([rank, rank * 3], np.int64)).tolist()}
    pairs = [(a, a + 1) for a in range(6)] + [(0, 3)]
    merged = pipeline.match_pairs(fake_match, pairs)
    res["pairs"] = {k: int(v[0].shape[0]) for k, v in merged.items()}
    res["metrics"] = gather_metrics(spec["metrics"][rank])
    res["ba"] = sharded_ba(spec["ba_problem"], rank, world, spec["ba_runs"])
    return res


def train_command(spec, rank, world, port):
    from casmtr_tpu_torch.cli import train as T
    writes = []
    losses = []
    scenes = []
    make = T.make_train_step

    def recording(*a, **kw):
        step = make(*a, **kw)

        def fn(state, batch):
            state, s = step(state, batch)
            losses.append(float(s["loss"]))
            return state, s
        return fn

    class Module(T.MultiSceneDataModule):
        def train_dataset(self):
            ds = super().train_dataset()
            scenes.extend(d.scene_id for d in ds.datasets)
            return ds

    dump, save = T.dump, T.CheckpointManager.save

    def dump_rec(*a, **kw):
        writes.append("config")
        return dump(*a, **kw)

    def save_rec(self, *a, **kw):
        writes.append("checkpoint")
        return save(self, *a, **kw)

    T.make_train_step, T.MultiSceneDataModule, T.dump = (recording, Module,
                                                         dump_rec)
    T.CheckpointManager.save = save_rec
    out = T.main(spec["argv"] + [
        "--dist-coordinator", f"localhost:{port}",
        "--dist-num-processes", str(world), "--dist-process-id", str(rank)])
    return {"step": out["step"], "val": out["val"], "losses": losses,
            "writes": writes, "scenes": scenes}


def main():
    mode, spec_path, rank, world, port, out = sys.argv[1:7]
    rank, world = int(rank), int(world)
    spec = torch.load(spec_path, weights_only=False)
    try:
        fn = checks if mode == "checks" else train_command
        res = fn(spec, rank, world, port)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))


if __name__ == "__main__":
    main()
