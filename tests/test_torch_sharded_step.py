"""The sharded train step computes the single-process function: four
processes on gloo (a ``FileStore`` in the test's directory, no port)
run reduced qwen2-0.5b in float32 under ``lm_rules`` on a (data 2,
model 2) DTensor mesh; the loss and every gradient, gathered, equal the
one-process step's within 1e-5 relative.  (A fake group moves no data,
so only real collectives can show this.)"""

import os

import numpy as np
import torch
import torch.multiprocessing as mp

WORLD = 4
RTOL = 1e-5


def _reference(cfg, batch):
    from repro_torch.models import build_model
    from repro_torch.train import make_loss_fn
    from repro_torch.utils import leaves_with_paths
    model = build_model(cfg, "cpu", torch.Generator().manual_seed(0))
    params = model.params()
    loss, _ = make_loss_fn(model, "full")(params, batch)
    paths, leaves = zip(*leaves_with_paths(params))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return model, float(loss), dict(zip(paths, grads))


def _worker(rank, store_path, out_dir):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import (batch_spec, like_placements,
                                           lm_rules, mesh_context,
                                           placements)
    from repro_torch.models import make_synthetic_batch, train_batch_specs
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.train import make_loss_fn
    from repro_torch.utils import leaves_with_paths, tree_map

    torch.manual_seed(0)
    torch.set_num_threads(1)        # four ranks beside the other workers
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD)
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        cfg = get_config("qwen2-0.5b").reduced()
        shape = ShapeSpec("train_4k", 32, 8, "train")
        batch = make_synthetic_batch(cfg, shape, device="cpu",
                                     generator=torch.Generator()
                                     .manual_seed(1))
        model, ref_loss, ref_grads = _reference(cfg, batch)
        params = model.params()
        p_spec = lm_rules(cfg.family).tree(params, mesh)
        b_spec = batch_spec(train_batch_specs(cfg, shape), mesh)
        sharded = tree_map(lambda t, sp: distribute_tensor(
            t.detach(), mesh, placements(sp, mesh)).requires_grad_(),
            params, p_spec)
        model._set_tree(sharded)
        dbatch = tree_map(lambda t, sp: distribute_tensor(
            t, mesh, placements(sp, mesh)), batch, b_spec)
        with mesh_context(mesh), implicit_replication():
            leaves = [t for _, t in leaves_with_paths(model.params())]
            loss, _ = make_loss_fn(model, "full")(model.params(), dbatch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
            grads = [like_placements(g, p) for g, p in zip(grads, leaves)]
            full = [g.full_tensor() for g in grads]
            got_loss = float(loss.full_tensor())
        paths = [p for p, _ in leaves_with_paths(model.params())]
        worst = {}
        for path, g in zip(paths, full):
            want = ref_grads[path]
            den = float(want.abs().max()) or 1.0
            worst[path] = float((g - want).abs().max()) / den
        np.save(os.path.join(out_dir, f"rank{rank}.npy"),
                np.array([got_loss, ref_loss] + [worst[p] for p in paths]))
        with open(os.path.join(out_dir, f"rank{rank}.paths"), "w") as f:
            f.write("\n".join(paths))
    finally:
        dist.destroy_process_group()


def test_sharded_loss_and_grads_equal_one_process(tmp_path):
    ctx = mp.get_context("spawn")
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env_path = os.environ.get("PYTHONPATH", "")
    os.environ["PYTHONPATH"] = src + os.pathsep + env_path
    try:
        procs = [ctx.Process(target=_worker,
                             args=(r, str(tmp_path / "store"),
                                   str(tmp_path)))
                 for r in range(WORLD)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(120)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
        assert not alive, "a rank hung"
        assert all(p.exitcode == 0 for p in procs), \
            [p.exitcode for p in procs]
    finally:
        os.environ["PYTHONPATH"] = env_path
    for r in range(WORLD):
        vals = np.load(tmp_path / f"rank{r}.npy")
        paths = (tmp_path / f"rank{r}.paths").read_text().splitlines()
        got_loss, ref_loss, errs = vals[0], vals[1], vals[2:]
        assert abs(got_loss - ref_loss) <= RTOL * abs(ref_loss), r
        assert len(errs) == len(paths) == 14
        for path, err in zip(paths, errs):
            assert err <= RTOL, (r, path, err)
