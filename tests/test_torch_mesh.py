"""The port's mesh layer (``repro_torch.launch.mesh``,
``launch.shardings``, ``models.sharding``, the zoo's specs) against the
reference's, in process on the CPU.

The rule tables are held equal to the reference's for every arch, each
of its shapes' kinds and batches (``shapes_for``), the meshes (1, 1),
(2, 4), (16, 16) and (2, 16, 16) and all six parallelisms; the
reference's functions read only ``mesh.shape`` and ``mesh.axis_names``,
and the port's only ``mesh_dim_names`` and ``shape``, so stand-in meshes
serve both.  Every spec (parameters, caches, batches) resolves to the
reference's ``PartitionSpec`` entries, the reference's stacked
``"layers"`` dim dropped.  The production meshes themselves are built on
the fake process group (``FakeStore``) at 256 and 512 ranks, in a
subprocess.  The multi-rank runs are in ``test_torch_mesh_*.py``.
"""

import json
import os
import subprocess
import sys
import textwrap
import types

import pytest
import torch

from repro.configs import ARCH_NAMES as JAX_ARCHS
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.configs.shapes import shapes_for
from repro.launch import shardings as ref_sh
from repro.models.sharding import ModelContext as JaxCtx
from repro.models.sharding import default_rules as ref_default_rules
from repro.models.zoo import build_model as jax_build
from repro_torch.configs import ARCH_NAMES, get_config, get_smoke_config
from repro_torch.launch import shardings
from repro_torch.models import moe, zoo
from repro_torch.models.sharding import (
    ModelContext, default_rules, placements, resolve_spec)
from repro_torch.models.zoo import build_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"1x1": (1, 1), "2x4": (2, 4), "16x16": (16, 16),
          "2x16x16": (2, 16, 16)}
PARALLELISMS = ("tp", "tp-sp", "fsdp", "dp", "ring", "vtp")


def _names(shape: tuple) -> tuple:
    return ("data", "model") if len(shape) == 2 else ("pod", "data", "model")


def _ref_mesh(shape: tuple):
    names = _names(shape)
    return types.SimpleNamespace(shape=dict(zip(names, shape)),
                                 axis_names=names)


def _port_mesh(shape: tuple):
    return types.SimpleNamespace(mesh_dim_names=_names(shape), shape=shape,
                                 ndim=len(shape))


def _leaves(tree, path=()):
    """(path, names) of every logical-names tuple in a spec tree."""
    if isinstance(tree, tuple) and all(isinstance(e, (str, type(None)))
                                       for e in tree):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))


def _ref_leaf(ref_specs: dict, name: str) -> tuple:
    """The reference's spec of the port parameter ``name``, its stacked
    "layers" dim dropped."""
    parts = name.split(".")
    if len(parts) == 1:
        return ref_specs[parts[0]]
    leaf = ref_specs[parts[0]][parts[-1]]
    if parts[0] == "shared_attn":
        return leaf
    assert leaf[0] == "layers", (name, leaf)
    return leaf[1:]


def test_archs_match():
    assert tuple(ARCH_NAMES) == tuple(JAX_ARCHS)


def test_default_rules_match():
    for multi_pod in (False, True):
        for sp in (False, True):
            assert (default_rules(multi_pod, sp)
                    == ref_default_rules(multi_pod, sp))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_rules_and_specs_match_reference(arch, mesh):
    """make_rules, zero_rules and every resolved spec (the port's names
    for each parameter leaf, the cache and the batch) equal the
    reference's, for each of the arch's shapes x all six parallelisms."""
    shape = MESHES[mesh]
    cfg, jcfg = get_config(arch), jax_config(arch)
    jm = jax_build(jcfg)
    ref_params = jm.param_specs()
    table = zoo.spec_table(cfg)
    pairs = []                                  # (port names, ref names)
    for path, names in _leaves(ref_params):
        port = table[path[0]] if len(path) == 1 else table[path[0]][path[-1]]
        ref = names if path[0] in ("embed", "final_norm", "lm_head",
                                   "shared_attn") else names[1:]
        assert port == ref, (path, port, names)
        pairs.append((port, names))
    for (_, pn), (_, rn) in zip(_leaves(zoo.cache_specs(cfg)),
                                _leaves(jm.cache_specs())):
        assert pn == rn
        pairs.append((pn, rn))
    assert zoo.batch_logical_axes(cfg) == jm.batch_logical_axes()
    for names in zoo.batch_logical_axes(cfg).values():
        pairs.append((names, names))
    checked = 0
    for sh in shapes_for(arch):
        for par in PARALLELISMS:
            want = ref_sh.make_rules(jcfg, _ref_mesh(shape), sh.kind,
                                     sh.batch, parallelism=par)
            got = shardings.make_rules(cfg, _port_mesh(shape), sh.kind,
                                       sh.batch, parallelism=par)
            assert got == want, (sh.name, par)
            zw, zg = ref_sh.zero_rules(want), shardings.zero_rules(got)
            assert zg == zw
            for port, ref in pairs:
                for rg, rw in ((got, want), (zg, zw)):
                    ref_spec = tuple(ref_sh._spec_from_names(ref, rw))
                    if len(ref) != len(port):          # the layers dim
                        assert ref_spec[0] is None
                        ref_spec = ref_spec[1:]
                    assert shardings._spec_from_names(port, rg) == ref_spec
                    checked += 1
    assert checked > 0


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_every_tensor_has_the_reference_spec(arch):
    """Each parameter and cache tensor of the port's smoke model has a
    spec of its ndim, equal to the reference's leaf."""
    cfg = get_smoke_config(arch)
    model = build_model(cfg, "cpu")
    ref = jax_build(jax_smoke(arch))
    specs = zoo.param_specs(model)
    params = dict(model.named_parameters())
    assert set(specs) == set(params)
    for name, p in params.items():
        assert len(specs[name]) == p.ndim, name
        assert specs[name] == _ref_leaf(ref.param_specs(), name), name
    cache = model.init_cache(2, 8)
    got = list(_leaves(zoo.cache_specs(cfg)))
    want = list(_leaves(ref.cache_specs()))
    assert got == want
    tensors = ([t for st in cache for t in st] if isinstance(cache, list)
               else [cache["mamba"]["conv"], cache["mamba"]["ssm"],
                     cache["k"], cache["v"]] if "mamba" in cache
               else [cache["k"], cache["v"]])
    assert [len(n) for _, n in got] == [t.ndim for t in tensors]


def _spec_mesh(names: tuple, sizes: tuple = None):
    sizes = sizes or (2,) * len(names)
    return types.SimpleNamespace(mesh_dim_names=names, ndim=len(names),
                                 size=lambda i: sizes[i])


def test_placements():
    from torch.distributed.tensor import Replicate, Shard
    mesh = _spec_mesh(("pod", "data", "model"))
    assert placements((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert placements((None, "data"), mesh) == (
        Replicate(), Shard(1), Replicate())
    # a one-rank mesh dim holds the whole dim: replicated
    assert placements((("pod", "data"), None, "model"), _spec_mesh(
        ("pod", "data", "model"), (2, 1, 4))) == (
        Shard(0), Replicate(), Shard(2))
    with pytest.raises(ValueError, match="order"):
        placements((("data", "pod"),), mesh)
    with pytest.raises(ValueError, match="not on the mesh"):
        placements(("pod",), _spec_mesh(("data", "model")))


def test_model_context_spec_dedupes_like_the_reference():
    from torch.distributed.tensor import Replicate, Shard
    rules = default_rules(seq_parallel=True)
    want = tuple(JaxCtx(rules=rules).spec("batch", "seq", "vocab"))
    got = ModelContext(rules=rules).entries("batch", "seq", "vocab")
    assert got == want == ("data", "model", None)
    ctx = ModelContext(mesh=_spec_mesh(("data", "model")), rules=rules)
    assert ctx.distributed
    assert ctx.spec("batch", "seq", "vocab") == (Shard(0), Shard(1))
    assert ctx.named_sharding("batch", "vocab") == (Shard(0), Shard(1))
    assert resolve_spec(("experts", "d_model"),
                        {"experts": "model", "d_model": ("data", "model")}
                        ) == ("model", "data")


def test_shard_is_a_noop_without_a_mesh():
    x = torch.ones(2, 3)
    for ctx in (ModelContext(), ModelContext(rules=default_rules())):
        assert not ctx.distributed
        assert ctx.shard(x, "batch", "d_model") is x
        assert ctx.named_sharding("batch", "d_model") is None


def test_capacity_and_dispatch_slots():
    """The reference's capacity and slot order: pairs sorted by expert,
    tokens in order within an expert, the ones past C dropped."""
    assert moe.capacity(16, 2, 1.0, 8) == 4
    assert moe.capacity(1, 1, 0.1, 8) == 1
    idx = torch.tensor([[0, 1], [0, 2], [0, 1], [1, 0]])
    order, se, sc, keep = moe.dispatch_slots(idx, 3, 2)
    assert order.tolist() == [0, 2, 4, 7, 1, 5, 6, 3]
    assert keep.tolist() == [True, True, False, False, True, True, False,
                             True]
    assert se.tolist() == [0, 0, 0, 0, 1, 1, 0, 2]
    assert sc.tolist() == [0, 1, 0, 0, 0, 1, 0, 0]


PRODUCTION = textwrap.dedent("""
    import json
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.configs import ARCH_NAMES, get_config
    from repro_torch.configs.shapes import shapes_for
    from repro_torch.launch.mesh import make_production_mesh, mesh_shape
    from repro_torch.launch.shardings import make_rules
    out = {}
    for world, multi_pod in ((256, False), (512, True)):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
        try:
            make_production_mesh(multi_pod=not multi_pod, device="cpu")
            raise SystemExit("a mesh of the wrong size was built")
        except ValueError:
            pass
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        rules = {}
        for arch in ARCH_NAMES:
            for sh in shapes_for(arch):
                for par in ("tp", "fsdp", "ring", "vtp"):
                    r = make_rules(get_config(arch), mesh, sh.kind, sh.batch,
                                   parallelism=par)
                    rules[f"{arch}|{sh.name}|{par}"] = {
                        k: list(v) if isinstance(v, tuple) else v
                        for k, v in r.items()}
        out[str(world)] = dict(names=list(mesh.mesh_dim_names),
                               shape=mesh_shape(mesh), rules=rules)
        dist.destroy_process_group()
    print(json.dumps(out))
""")


def test_production_meshes_on_the_fake_process_group():
    """make_production_mesh at 256 and 512 fake ranks: the reference's
    shapes and axes, a mesh of the wrong size refused, and the rules on
    the real DeviceMesh equal to the reference's."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", PRODUCTION], capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    for world, shape in (("256", (16, 16)), ("512", (2, 16, 16))):
        got = out[world]
        assert tuple(got["names"]) == _names(shape)
        assert tuple(got["shape"][a] for a in got["names"]) == shape
        for key, rules in got["rules"].items():
            arch, name, par = key.split("|")
            sh = next(s for s in shapes_for(arch) if s.name == name)
            want = ref_sh.make_rules(jax_config(arch), _ref_mesh(shape),
                                     sh.kind, sh.batch, parallelism=par)
            want = {k: list(v) if isinstance(v, tuple) else v
                    for k, v in want.items()}
            assert rules == want, key
