"""The ranks' side of tests/test_torch_port_parallel.py (on the CPU) and of
the parallel cases of tests/test_torch_port_cuda.py (every rank on cuda:0):
functions that `tachikoma_tpu_torch.parallel.gather.launch` runs in spawned
processes over one process group.  No jax here: the ranks import the port
only; the tests compare their results in the parent.
"""

import io

import numpy as np

MESHES = ({"dp": 4}, {"dp": 2, "tp": 2}, {"tp": 4})
EXPERTS = (2, 4)
RINGS = (2, 4)
SCALES = dict(scores_scale=0.02, v_scale=0.1, output_scale=0.12)


def integer_nodes(graph) -> list[str]:
    return [n.name for n in graph.nodes
            if n.dtype in ("int8", "int32") and not n.is_const and not n.is_var]


def _key(axes) -> str:
    return ",".join(f"{k}{v}" for k, v in axes.items())


def moe_case():
    rng = np.random.default_rng(0)
    T, K, N, E = 64, 32, 48, 8
    x = rng.integers(-128, 128, (T, K)).astype(np.int8)
    w = rng.integers(-128, 128, (E, K, N)).astype(np.int8)
    from tachikoma_tpu_torch.parallel.moe import top1_gate

    return x, w, top1_gate(x, rng.integers(-128, 128, (K, E)).astype(np.int8))


def ring_case():
    rng = np.random.default_rng(0)
    return tuple(rng.integers(-128, 128, (2, 4, 64, 32)).astype(np.int8) for _ in range(3))


def parallel_round(rank, world, artifacts, feeds, moe_case, ring_case, device="cpu"):
    """Every parallel path on this rank, on `device` ("cuda:0": every rank
    on one card, over gloo).  `artifacts` maps a model name to a .tkmod of
    its int8 graph, `feeds` to its input.  Returns, on rank 0, the global
    values; every rank returns digests of what it got, so the test can see
    that each rank holds the same global values."""
    import hashlib

    import torch

    from tachikoma_tpu_torch.parallel import gather
    from tachikoma_tpu_torch.parallel.gather import ShardedTraceEmitter, _with_retry
    from tachikoma_tpu_torch.parallel.mesh import Topology, simple_mesh
    from tachikoma_tpu_torch.parallel.moe import ExpertParallelDense, moe_dense_int8
    from tachikoma_tpu_torch.parallel.ring_attention import ring_attention_int8
    from tachikoma_tpu_torch.parallel.shard import ShardedExecutor
    from tachikoma_tpu_torch.runtime.artifact import load_artifact

    torch.set_num_threads(1)
    out = {"captures": {}, "plans": {}, "traces": {}, "digests": {}, "moe": {}, "moe_kept": {},
           "ring": {}}

    def digest(arrays):
        h = hashlib.sha256()
        for a in arrays:
            h.update(np.ascontiguousarray(a).tobytes())
        return h.hexdigest()

    for model, path in artifacts.items():
        q, _ = load_artifact(path)
        names = integer_nodes(q) + list(q.outputs)
        for axes in MESHES:
            mesh = simple_mesh(axes, backend="gloo", device=device)
            ex = ShardedExecutor(q, mesh, capture=names)
            got = ex.run(feeds[model])
            key = (model, _key(axes))
            out["digests"][key] = digest(got)
            out["plans"][key] = ex.plan_counts()
            if rank == 0:
                out["captures"][key] = dict(zip(names, got))
            if model == "lenet5":
                em = ShardedTraceEmitter(q, mesh)
                blob = em.emit_bytes(feeds[model])
                if rank == 0:
                    out["traces"][key] = blob

    # a step that fails twice is retried, and the trace is the same
    q, _ = load_artifact(artifacts["lenet5"])
    em = ShardedTraceEmitter(q, simple_mesh({"dp": 2, "tp": 2}, backend="gloo", device=device))
    run, fails = em._ex.run_device, [2]

    def flaky(inputs):
        if fails[0]:
            fails[0] -= 1
            raise ConnectionError("injected")
        return run(inputs)

    em._ex.run_device = flaky
    buf = io.BytesIO()
    manifest = em.emit(feeds["lenet5"], buf if rank == 0 else None)
    out["retried"] = (buf.getvalue() if rank == 0 else None, manifest["records"])
    try:
        _with_retry(lambda: 1 // 0, "always", retries=2, backoff=0.0)
    except RuntimeError as e:
        out["exhausted"] = (str(e), type(e.__cause__).__name__)

    x, w, gate = moe_case
    for ep in EXPERTS:
        mesh = simple_mesh({"ep": ep}, backend="gloo", device=device)
        if mesh.member:
            out["moe"][ep] = moe_dense_int8(x, w, gate, mesh, axis="ep").cpu().numpy()
            kept = ExpertParallelDense(w, mesh, axis="ep")
            out["moe_kept"][ep] = [kept(x, gate).cpu().numpy(),
                                   kept(x[::-1], gate[::-1]).cpu().numpy()]
    qq, kk, vv = ring_case
    for sp in RINGS:
        mesh = simple_mesh({"sp": sp}, backend="gloo", device=device)
        if mesh.member:
            out["ring"][sp] = (ring_attention_int8(qq, kk, vv, mesh, **SCALES).cpu().numpy(),
                               mesh.stats_snapshot())

    # a mesh over the first two ranks: the others are not members
    mesh = simple_mesh({"tp": 2}, backend="gloo", device=device)
    out["member"] = mesh.member
    try:
        ShardedExecutor(q, mesh)
        out["non_member_raises"] = False
    except ValueError:
        out["non_member_raises"] = True
    topo = Topology(dp=2, tp=2).make_mesh(backend="gloo", device=device)
    out["topology"] = (topo.axis_names, dict(topo.axes), dict(topo.coords))
    try:
        Topology(dp=16).make_mesh(backend="gloo", device=device)
    except ValueError as e:
        out["too_big"] = str(e)
    out["coordinator"] = gather.is_coordinator()
    return out


def forced_row_parallel(rank, world, path, x):
    """The JAX package's test_collectives_inserted: every dense weight whose
    K axis divides forced split over 'tp' on K (a row-parallel product and
    its int32 all-reduce)."""
    import torch

    from tachikoma_tpu_torch.parallel.mesh import simple_mesh
    from tachikoma_tpu_torch.parallel.shard import ShardedExecutor
    from tachikoma_tpu_torch.runtime.artifact import load_artifact

    torch.set_num_threads(1)
    q, _ = load_artifact(path)
    specs = {name: ("tp", None) for name, arr in q.params.items()
             if arr.ndim == 2 and arr.shape[0] % world == 0}
    mesh = simple_mesh({"tp": world}, backend="gloo", device="cpu")
    ex = ShardedExecutor(q, mesh, param_specs=specs)
    return ex.run(x)[0], ex.plan_counts(), sorted(specs), mesh.stats_snapshot()


def failing(rank, world):
    if rank == 1:
        raise RuntimeError("rank 1 fails")
    return rank


def nccl_world_of_one(rank, world):
    """A one-rank NCCL group (a mesh's subgroup beside the default gloo
    group): the collective helper's all-reduce and all-gather on card
    tensors, no host byte."""
    import torch

    from tachikoma_tpu_torch.parallel.mesh import simple_mesh

    torch.cuda.set_device(0)
    mesh = simple_mesh({"dp": 1}, backend="nccl", device="cuda:0")
    line = mesh.collective("dp")
    t = torch.arange(-7, 300, dtype=torch.int32, device="cuda:0")
    ok = torch.equal(line.all_reduce(t.clone()), t) and torch.equal(line.all_gather(t, 0), t)
    return ok, mesh.stats_snapshot()


def world_of_one(rank, world):
    """One rank: its process group exists, and a one-rank mesh's
    collectives return their input."""
    import torch
    import torch.distributed as dist

    from tachikoma_tpu_torch.parallel.mesh import simple_mesh

    line = simple_mesh(backend="gloo", device="cpu").collective("dp")
    t = torch.arange(-3, 5, dtype=torch.int32)
    return (dist.get_world_size(), torch.equal(line.all_reduce(t.clone()), t),
            torch.equal(line.all_gather(t, 0), t))


def default_group(rank, world):
    """The default group's backend and size, and an int32 SUM over it."""
    import torch
    import torch.distributed as dist

    t = torch.full((3,), rank + 1, dtype=torch.int32)
    dist.all_reduce(t)
    return dist.get_backend(), dist.get_world_size(), t.tolist()
