"""Rank programs of the port's multi-rank CPU tests
(``test_torch_port_mesh*.py``).

Each function is one rank's program, started by
``theatergen_tpu_torch.parallel.worker.spawn`` as ``fn(rank, world,
address, path, ...)``: it joins a gloo world on the CPU with one thread and
a TIMEOUT_S process-group timeout, reads its inputs from ``path``
(``torch.save``d by the test) and rank 0 writes its results beside them.
The module imports neither JAX nor the JAX package, so a rank starts in a
few seconds; the tests compare the results with the JAX package.
"""

import os

import torch
import torch.distributed as dist

from theatergen_tpu_torch.models import layers
from theatergen_tpu_torch.parallel import collectives
from theatergen_tpu_torch.parallel import mesh as mesh_lib
from theatergen_tpu_torch.parallel import worker

# every process group's timeout (a rank that dies mid-collective fails
# its peers after this long) and the tests' join limit
TIMEOUT_S = 60


def _mesh(rank, world, address, dp, tp):
    torch.set_num_threads(1)
    mesh_lib.init_distributed("cpu", address=address, rank=rank,
                              world_size=world, timeout_s=TIMEOUT_S)
    return mesh_lib.make_mesh(dp, tp, device="cpu", timeout_s=TIMEOUT_S,
                              command_timeout_s=TIMEOUT_S)


def _load(path):
    return torch.load(os.path.join(path, "inputs.pt"), weights_only=False)


def _save(path, obj):
    torch.save(obj, os.path.join(path, "results.pt"))


def _contiguous_geglu(kind, size, tp, index):
    """A planted fault: GEGLU's ``[value ‖ gate]`` rows cut contiguously
    (rank 0 every value row, rank 1 every gate row)."""
    return _SHARD_ROWS("column", size, tp, index)


_SHARD_ROWS = mesh_lib.shard_rows


def _bias_on_every_rank(self, x):
    """A planted fault: the row-parallel bias added before the reduce, so
    once per rank."""
    y = torch.nn.functional.linear(x, self.weight, self.bias)
    return collectives.reduce_from(y, self.mesh)


def unet_forward(rank, world, address, path, dp, tp):
    """The UNet of ``inputs.pt`` sharded over a dp × tp mesh, each dp group
    on its rows of the batch (a W8A8 UNet on the ``fused_int8`` route);
    rank 0 saves the whole output, the output under each planted fault
    (dp = 1 only), and its collective counts."""
    from theatergen_tpu_torch.ops import quant as q_ops

    mesh = _mesh(rank, world, address, dp, tp)
    inp = _load(path)
    q_ops.FUSED_MODE = inp.get("fused_int8", "0")
    per = inp["x"].shape[0] // dp
    rows = slice(mesh.dp_index * per, (mesh.dp_index + 1) * per)

    def forward(unet):
        with torch.no_grad():
            return unet(inp["x"][rows], inp["t"][rows], inp["ctx"][rows],
                        ip_scale=inp["ip_scale"])

    mesh_lib.reset_stats(mesh)
    out = forward(mesh_lib.shard_module(inp["unet"], mesh))
    stats = mesh_lib.collective_stats(mesh)
    faults = {}
    if dp == 1:
        mesh_lib.shard_rows = lambda kind, *a: (
            _contiguous_geglu(kind, *a) if kind == "geglu"
            else _SHARD_ROWS(kind, *a))
        faults["geglu_contiguous"] = forward(
            mesh_lib.shard_module(inp["unet"], mesh))
        mesh_lib.shard_rows = _SHARD_ROWS
        plain = layers.RowParallelLinear.forward
        layers.RowParallelLinear.forward = _bias_on_every_rank
        faults["bias_twice"] = forward(mesh_lib.shard_module(inp["unet"],
                                                             mesh))
        layers.RowParallelLinear.forward = plain
    outs = collectives.gather_objects(mesh, out)
    if rank == 0:
        _save(path, dict(out=torch.cat([outs[g * tp] for g in range(dp)]),
                         faults=faults, stats=stats))
    dist.destroy_process_group()


def sp_attention(rank, world, address, path):
    """``sp_attention`` over dp = world: each rank its slice of q, k, v;
    rank 0 saves the gathered output and whether cutting an indivisible
    Sq raised on every rank."""
    from theatergen_tpu_torch.parallel import sp

    mesh = _mesh(rank, world, address, world, 1)
    inp = _load(path)
    q, k, v = (sp.sp_sharded(mesh, inp[n]) for n in ("q", "k", "v"))
    out = sp.sp_attention(q, k, v, mesh, use_flash=False)
    try:
        sp.sp_sharded(mesh, inp["q"][:, :-1])
        raised = False
    except ValueError as e:
        raised = "not divisible" in str(e)
    outs = collectives.gather_objects(mesh, (out, raised))
    if rank == 0:
        _save(path, dict(out=torch.cat([o[0] for o in outs], 1),
                         raised=all(o[1] for o in outs)))
    dist.destroy_process_group()


def runners(rank, world, address, path, dp, tp):
    """The dp character and final runners of ``inputs.pt``'s bundle over a
    dp × tp mesh, rank 0 calling them on the given rows; the other ranks
    serve."""
    from theatergen_tpu_torch.parallel import driver

    mesh = _mesh(rank, world, address, dp, tp)
    inp = _load(path)
    bundle = inp["bundle"]

    def main():
        c = inp["char"]
        run, _ = driver.make_dp_character_runner(
            bundle, c["steps"], mesh, capture_ref_attn=True, **c["kw"])
        res = run(c["latents"], c["contexts"], c["scales"], None,
                  c["generators"], word_tokens=c["words"])
        f = inp["final"]
        frun, _ = driver.make_dp_final_runner(bundle, f["steps"], mesh,
                                              guided=False)
        final = frun(*f["args"], generators=f["generators"])
        _save(path, dict(char=res, final=final,
                         stats=mesh_lib.collective_stats(mesh)))

    code = worker.run_rank(mesh, main, bundle)
    dist.destroy_process_group()
    if code:
        raise SystemExit(code)


def _raising(*_):
    raise RuntimeError("planted failure on rank 1")


def rank_raises(rank, world, address, path):
    """Rank 1's command raises: rank 0 gets a RankError and aborts, every
    rank exits non-zero (rank 0 by the error, rank 1 by the abort)."""
    mesh = _mesh(rank, world, address, world, 1)
    worker.register(mesh, "t", _Target(rank))
    code = worker.run_rank(mesh, lambda: worker.dispatch(
        mesh, dict(kind="call", name="t", method="go"), [()] * world))
    raise SystemExit(code)


class _Target:
    def __init__(self, rank):
        self.rank = rank

    def go(self):
        if self.rank == 1:
            _raising()
        return self.rank


def train(rank, world, address, path, dp, tp):
    """``shard_train_step`` over a dp × tp mesh on ``inputs.pt``'s UNet:
    five steps on its batch (rank 0 saves the losses), then, where a
    checkpoint to reshard is given, the sharded step's ``load`` of it and
    ``save_sharded`` into ``out_ckpt``."""
    from theatergen_tpu_torch.training import checkpoint as ckpt
    from theatergen_tpu_torch.training import diffusion as trainer

    mesh = _mesh(rank, world, address, dp, tp)
    inp = _load(path)
    step = trainer.make_train_step(inp["unet"], trainer.make_optimizer(
        lr=1e-3, warmup=0), inp["sched"], device="cpu",
        trainable_filter=inp.get("filter"))
    sharded = trainer.shard_train_step(step, mesh)

    def main():
        state = sharded.init_state()
        ema = sharded.init_ema(state)
        losses = []
        for i in range(inp["steps"]):
            state, loss = sharded(state, inp["lat"], inp["ctx"],
                                  t=inp["t"][i], noise=inp["noise"][i])
            ema = sharded.ema_update(ema, state, 0.9)
            losses.append(float(loss))
        out = dict(losses=losses)
        if "in_ckpt" in inp:
            tree = sharded.load(inp["in_ckpt"])
            ckpt.save_sharded(inp["out_ckpt"], sharded, tree["state"],
                              tree["ema"])
        _save(path, out)

    code = worker.run_rank(mesh, main)
    dist.destroy_process_group()
    if code:
        raise SystemExit(code)


def server(rank, world, address, path, dp):
    """``TheaterServer(mesh=)`` over dp ranks on ``inputs.pt``'s bundle:
    rank 0 opens one session per spec, submits their first turns together
    (one wave) and saves the images; the other ranks serve."""
    from theatergen_tpu_torch.serve import TheaterServer

    mesh = _mesh(rank, world, address, dp, 1)
    inp = _load(path)
    bundle = inp["bundle"]

    def main():
        srv = TheaterServer(bundle, os.path.join(path, "db"), mesh=mesh,
                            wave_policy="always", batch_window_s=2.0,
                            num_steps=inp["steps"])
        try:
            futs = []
            for i, spec in enumerate(inp["specs"]):
                srv.open_session(f"s{i}")
                futs.append(srv.submit(f"s{i}", spec, seed=inp["seeds"][i]))
            images = [f.result(TIMEOUT_S).image for f in futs]
            _save(path, dict(images=images, waves=srv.waves_run))
        finally:
            srv.close()

    code = worker.run_rank(mesh, main, bundle)
    dist.destroy_process_group()
    if code:
        raise SystemExit(code)
