"""The port's ``parallel/`` in one process, against the JAX package's
``parallel/``: the helpers outside a process group, per-process feeding as
1, 2 and 4 processes see it (and the data-parallel groups of a ``(data,
tensor)`` mesh), the fsdp rule leaf for leaf on the tiny checkpoint, the
backend rule and the schedule stretched by the process count. The
multi-process runs are ``tests/test_torch_parallel_train.py``'s,
``test_torch_parallel_fsdp.py``'s and ``test_torch_tensor_parallel*.py``'s.
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec

from mapperatorinator_tpu import parallel as jax_parallel
from mapperatorinator_tpu.train import optim as jax_optim
from mapperatorinator_tpu_torch import parallel
from mapperatorinator_tpu_torch.models.params import flax_paths
from mapperatorinator_tpu_torch.parallel import distributed
from mapperatorinator_tpu_torch.parallel.sharding import flax_shape, gathered, shard_of, sharded_norm, torch_dim
from mapperatorinator_tpu_torch.train import optim
from tests.test_torch_model import tiny  # noqa: F401  (module fixture)
from tests.test_torch_train import configs


def test_single_process_helpers_are_noops():
    """As ``tests/test_multihost.py:22``: outside a process group nothing
    changes."""
    assert parallel.process_local_batch_size(16) == 16
    assert list(parallel.shard_iterator_by_process(iter(range(5)))) == [0, 1, 2, 3, 4]
    assert parallel.maybe_initialize(None) is False
    assert parallel.maybe_initialize(SimpleNamespace(coordinator_address=None, num_processes=2, process_id=1)) is False
    assert parallel.make_global_mesh(None, "cpu") is None
    assert (parallel.world_size(), parallel.process_index()) == (1, 0)
    batch = parallel.make_global_batch({"labels": np.arange(6).reshape(2, 3), "frames": np.ones((2, 4))}, "cpu")
    assert batch["labels"].dtype == torch.long and batch["frames"].dtype == torch.float32


# (processes, mesh): the process count alone, or a mesh with a tensor axis (axis names, shape)
FEEDING = [(1, None), (2, None), (4, None), (4, (("data", "tensor"), (2, 2))), (4, (("tensor",), (4,))),
           (8, (("data", "fsdp", "tensor"), (2, 2, 2))), (6, (("tensor", "data"), (2, 3)))]


@pytest.mark.parametrize("processes,mesh", FEEDING)
def test_per_process_feeding_matches_jax(monkeypatch, processes, mesh):
    """Each process's examples and its share of the batch, as the JAX
    functions give them for the same process count and index; under a
    tensor axis, for the data-parallel groups' count and index: the ranks of
    one tensor group get the same rows, and the groups disjoint ones that
    cover the stream."""
    names, shape = mesh or (("data",), (processes,))
    args = SimpleNamespace(axis_names=list(names), mesh_shape=list(shape),
                           tensor_axis="tensor" if "tensor" in names else None)
    rows = {}
    for index in range(processes):
        coords = np.unravel_index(index, shape)
        kept = [(c, s) for c, s, name in zip(coords, shape, names) if name != "tensor"]
        group = int(np.ravel_multi_index([c for c, _ in kept], [s for _, s in kept])) if kept else 0
        groups = int(np.prod([s for _, s in kept]))
        monkeypatch.setattr(distributed, "world_size", lambda: processes)
        monkeypatch.setattr(distributed, "process_index", lambda: index)
        monkeypatch.setattr(jax, "process_count", lambda: groups)
        monkeypatch.setattr(jax, "process_index", lambda: group)
        assert parallel.data_parallel_rank(args) == (group, groups)
        got = list(parallel.shard_iterator_by_process(iter(range(11)), args))
        assert got == list(jax_parallel.shard_iterator_by_process(iter(range(11))))
        assert got == list(range(group, 11, groups))
        assert parallel.process_local_batch_size(24, args) == jax_parallel.process_local_batch_size(24) \
            == 24 // groups
        rows.setdefault(group, []).append(got)
        if mesh is None:  # without a mesh the process is its own group
            assert list(parallel.shard_iterator_by_process(iter(range(11)))) == got
        if groups == 4:
            for fn in (lambda n: parallel.process_local_batch_size(n, args), jax_parallel.process_local_batch_size):
                with pytest.raises(ValueError, match="divisible"):
                    fn(6)
    assert all(r == members[0] for members in rows.values() for r in members)
    firsts = [members[0] for members in rows.values()]
    assert sorted(x for r in firsts for x in r) == list(range(11))


def jax_specs(jparams, mesh: Mesh, fsdp_axis: str) -> dict:
    specs = jax_parallel.param_specs(jparams, fsdp_axis=fsdp_axis, mesh=mesh)
    leaves, _ = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return {"/".join(str(k.key) for k in path): tuple(spec) for path, spec in leaves}


MESHES = {"fsdp2": ((2,), ("data",), "data"), "fsdp4": ((4,), ("data",), "data"),
          "fsdp8": ((8,), ("data",), "data"), "data2xfsdp2": ((2, 2), ("data", "fsdp"), "fsdp")}


@pytest.mark.parametrize("layout", list(MESHES))
def test_param_specs_match_jax_leaf_for_leaf(tiny, layout):  # noqa: F811
    """The fsdp rule on the tiny checkpoint: each leaf's spec equals the JAX
    ``param_specs``' (the largest dimension the axis divides, else
    replicated), the counts equal ``describe_sharding``'s, and the torch
    dimension a spec names has the flax dimension's size."""
    _, _, jparams, tmodel, _ = tiny
    shape, axes, fsdp = MESHES[layout]
    mesh = Mesh(np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(shape), axes)
    want = jax_specs(jparams, mesh, fsdp)
    got = parallel.param_specs(tmodel, fsdp_axis=fsdp, mesh=dict(zip(axes, shape)))
    assert got == want
    assert any(fsdp in spec for spec in got.values())
    jax_counts = jax_parallel.describe_sharding(jparams, jax_parallel.param_specs(jparams, fsdp_axis=fsdp, mesh=mesh))
    assert parallel.describe_sharding(got) == jax_counts
    paths = flax_paths(tmodel)
    for name, param in tmodel.named_parameters():
        spec = got[paths[name]]
        if fsdp in spec:
            dim = spec.index(fsdp)
            assert param.shape[torch_dim(dim, param.dim(), paths[name])] == flax_shape(param.shape, paths[name])[dim]
    assert len(got) == len(list(tmodel.parameters()))


def test_backend_rule(monkeypatch):
    """gloo on the CPU; on CUDA, nccl where every rank of the host has a card
    of its own, gloo where ranks share one."""
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert parallel.distributed.choose_backend("cpu", 2)[0] == "gloo"
    assert parallel.distributed.choose_backend("cpu", 2, SimpleNamespace(cpu_collectives="mpi"))[0] == "mpi"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert parallel.distributed.choose_backend("cuda", 1)[0] == "nccl"
    assert parallel.distributed.choose_backend("cuda", 2)[0] == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert parallel.distributed.choose_backend("cuda", 4)[0] == "nccl"
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert parallel.distributed.choose_backend("cuda", 16)[0] == "nccl"  # 4 hosts of 4 ranks, 4 cards each
    assert parallel.distributed.rank_device(torch.device("cpu")) == torch.device("cpu")


@pytest.mark.parametrize("processes", [1, 2, 8])
@pytest.mark.parametrize("scheduler", ["cosine", "linear"])
def test_schedule_stretches_by_the_process_count_as_jax(processes, scheduler):
    """``build_optimizer(..., num_processes)`` stretches warmup, sustain and
    total steps as the JAX ``build_schedule`` does with the device count
    (``train.py:139``)."""
    overrides = ["optim.base_lr=0.01", "optim.warmup_steps=100", "optim.sustain_steps=50", "optim.total_steps=1000",
                 f"optim.lr_scheduler={scheduler}", "optim.final_cosine=1e-5"]
    jax_args, args = configs(overrides)
    want = jax_optim.build_schedule(jax_args.optim, num_processes=processes)
    got = optim.build_schedule(args.optim, processes)
    for count in (0, 1, 99, 100, 150, 199, 200, 300, 500, 999, 1500, 1999, 2000, 4000, 7999, 8000):
        assert got(count) == pytest.approx(float(want(count)), rel=1e-6, abs=1e-9), count


def test_shard_helpers_are_the_identity_on_plain_tensors():
    """Outside FSDP a tensor is whole: the helpers change nothing, and the
    global norm is the single-process expression, bit for bit."""
    ts = [torch.randn(3, 4, generator=torch.Generator().manual_seed(i)) for i in range(3)]
    assert all(gathered(t) is t and shard_of(t, t) is t for t in ts)
    assert torch.equal(optim.global_norm(ts), torch.sqrt(sum(t.float().pow(2).sum() for t in ts)))
    assert torch.allclose(sharded_norm(ts), optim.global_norm(ts))
