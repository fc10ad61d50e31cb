"""The port's mesh, sharding and multihost modules against the JAX
package's (``distllm_tpu.parallel``).

- ``MeshSpec.resolve`` over a table of cases equals JAX's, the errors'
  messages included.
- Each rank's slice from ``shard_pytree`` equals the matching
  ``addressable_shards`` entry of JAX's ``shard_pytree`` on the 8-device
  virtual mesh, for the Mistral (Qwen2 biases and an untied head), Gemma-2
  and Mixtral specs (``expert=2, model=2``). Exact: slicing moves bytes.
- An int8 ``QTensor`` sharded column- or row-parallel, the ranks'
  products concatenated or summed, equals the whole product within K2's
  plain-op tolerance (``quantized_matmul.comparison_tolerance`` on the
  CUDA-core route, fp32); a 4-D bank's scales split with its codes; an
  nf4 leaf's slice dequantizes to the whole leaf's slice bitwise.
- The families' ``init`` with a rank's ``leaf_sharder`` equals
  ``shard_pytree`` of the whole ``init`` bit for bit (int8 and nf4).
- ``init_multihost``'s topology precedence, its ``tcp://`` form, the
  backend it insists on, its idempotence; two processes joined from the
  pod scripts' environment variables, meshed over gloo and all-reduced.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from distllm_tpu.models import gemma as jax_gemma
from distllm_tpu.models import mistral as jax_mistral
from distllm_tpu.models import mixtral as jax_mixtral
from distllm_tpu.parallel import mesh as jax_mesh
from distllm_tpu.parallel.sharding import shard_pytree as jax_shard_pytree
from distllm_tpu_torch.models import gemma, mistral, mixtral
from distllm_tpu_torch.ops import quantization as tq
from distllm_tpu_torch.ops import quantized_matmul as tqm
from distllm_tpu_torch.parallel import comm, multihost
from distllm_tpu_torch.parallel import mesh as tmesh
from distllm_tpu_torch.parallel import sharding as tsh

REPO = Path(__file__).resolve().parent.parent


def rank_mesh(rank: int, **sizes) -> tmesh.Mesh:
    """Rank ``rank``'s view of a mesh, without process groups (slicing
    reads only the sizes and the coordinates)."""
    shape = tmesh.MeshSpec(data=1, **sizes).resolve(int(np.prod(list(sizes.values()))))
    return tmesh.Mesh(
        shape=shape, rank=rank, coords=tmesh._rank_coords(rank, shape), groups=None,
        backend=None, device=torch.device('cpu'), num_devices=1,
    )


# ------------------------------------------------------------------- mesh
RESOLVE_CASES = [
    (dict(), 8),
    (dict(data=-1, model=2), 8),
    (dict(data=1, model=2), 2),
    (dict(data=1, expert=4, model=2), 8),
    (dict(data=2, seq=2, expert=1, model=2), 8),
    (dict(data=1, seq=-1, model=4), 8),
    (dict(data=-1, model=3), 8),
    (dict(data=-1, model=-1), 8),
    (dict(data=1, model=2), 8),
    (dict(data=1, expert=2, model=2), 3),
]


@pytest.mark.parametrize('kwargs,n', RESOLVE_CASES)
def test_meshspec_resolve_matches_jax(kwargs, n):
    def outcome(spec_cls):
        try:
            return spec_cls(**kwargs).resolve(n)
        except ValueError as exc:
            return ('error', str(exc))

    assert outcome(tmesh.MeshSpec) == outcome(jax_mesh.MeshSpec)
    assert tmesh.AXIS_ORDER == jax_mesh.AXIS_ORDER


def test_rank_layout_and_groups_follow_the_jax_device_order():
    """Rank r sits where device r sits in the JAX mesh's device array; an
    axis group is the ranks along that axis."""
    jmesh = jax_mesh.make_mesh(jax_mesh.MeshSpec(data=2, expert=2, model=2))
    sizes = dict(jmesh.shape)
    for position, device in np.ndenumerate(jmesh.devices):
        coords = tmesh._rank_coords(device.id, sizes)
        assert tuple(coords[a] for a in tmesh.AXIS_ORDER) == position
    assert tmesh._group_ranks(sizes, ('model',)) == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert tmesh._group_ranks(sizes, tmesh.MOE_AXES) == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert tmesh._group_ranks(sizes, ('data',)) == [[0, 4], [1, 5], [2, 6], [3, 7]]


def test_nccl_on_one_device_raises_naming_gloo():
    tmesh.check_backend_devices('gloo', ['h:cuda:A', 'h:cuda:A'])
    tmesh.check_backend_devices('nccl', ['h:cuda:A', 'h:cuda:B'])
    with pytest.raises(ValueError, match="backend='gloo'"):
        tmesh.check_backend_devices('nccl', ['h:cuda:A', 'h:cuda:A'])


def test_rank_devices_follow_the_callers_device(monkeypatch):
    assert tmesh.rank_devices(3, 'cpu') == ['cpu'] * 3
    assert tmesh.rank_devices(2, torch.device('cpu')) == ['cpu', 'cpu']
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 2)
    assert tmesh.rank_devices(3) == ['cuda:0', 'cuda:1', 'cuda:0']
    assert tmesh.rank_devices(2, torch.device('cuda')) == ['cuda:0', 'cuda:1']
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    # Two ranks share the one card: NCCL then refuses them (above).
    assert tmesh.rank_devices(2, 'cuda') == ['cuda:0', 'cuda:0']


def test_single_device_mesh_binds_nothing():
    mesh = tmesh.single_device_mesh('cpu')
    assert mesh.size == 1 and mesh.groups is None and mesh.num_devices == 1
    cfg = mistral.MistralConfig(num_layers=1)
    assert comm.bind(cfg, mesh).tp is None and cfg.tp is None
    with pytest.raises(RuntimeError, match='init_multihost'):
        tmesh.make_mesh(tmesh.MeshSpec(data=1), devices=['cpu'], backend='gloo')


# --------------------------------------------------------------- sharding
def _tiny(cls, **extra):
    return cls(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
               intermediate_size=64, dtype='float32', **extra)


SHARD_CASES = {
    'qwen2-untied': (jax_mistral, mistral, dict(attention_bias=True), dict(model=2)),
    'gemma2-tied': (jax_gemma, gemma, dict(
        name='gemma2', head_dim=8, post_norms=True, norm_plus_one=True,
        tie_word_embeddings=True, sliding_window_pattern='alternating',
        sliding_window=4), dict(model=2)),
    'mixtral-ep2-tp2': (jax_mixtral, mixtral, dict(num_experts=4, experts_per_token=2),
                        dict(expert=2, model=2)),
}


def _config_classes(jax_module, port_module):
    names = {jax_mistral: 'MistralConfig', jax_gemma: 'GemmaConfig',
             jax_mixtral: 'MixtralConfig'}
    name = names[jax_module]
    return getattr(jax_module, name), getattr(port_module, name)


def _spec_tuples(specs):
    if isinstance(specs, dict):
        return {k: _spec_tuples(v) for k, v in specs.items()}
    return tuple(specs)


@pytest.mark.parametrize('case', sorted(SHARD_CASES))
def test_shard_pytree_matches_jax_addressable_shards(case):
    jax_module, port_module, extra, sizes = SHARD_CASES[case]
    jcls, tcls = _config_classes(jax_module, port_module)
    jcfg, tcfg = _tiny(jcls, **extra), _tiny(tcls, **extra)
    jtree = jax_module.init(jax.random.PRNGKey(1), jcfg)
    n = int(np.prod(list(sizes.values())))
    jmesh = jax_mesh.make_mesh(jax_mesh.MeshSpec(data=1, **sizes), devices=jax.devices()[:n])
    placed = jax_shard_pytree(jtree, jax_module.param_specs(jcfg, jtree), jmesh)
    whole = port_module.params_from_jax(jax.tree.map(np.asarray, jtree), tcfg, device='cpu')
    assert _spec_tuples(port_module.param_specs(tcfg, whole)) == _spec_tuples(
        jax_module.param_specs(jcfg, jtree))
    jleaves = jax.tree_util.tree_flatten_with_path(placed)[0]
    for rank in range(n):
        mesh = rank_mesh(rank, **sizes)
        device = jmesh.devices[tuple(mesh.coords[a] for a in tmesh.AXIS_ORDER)]
        local = tsh.shard_pytree(whole, port_module.param_specs(tcfg, whole), mesh)
        for path, leaf in jleaves:
            keys = [p.key for p in path]
            mine = local
            for key in keys:
                mine = mine[key]
            shard = next(s for s in leaf.addressable_shards if s.device == device)
            np.testing.assert_array_equal(mine.numpy(), np.asarray(shard.data), err_msg=str(keys))


@pytest.mark.parametrize('parallel', ['column', 'row'])
def test_int8_shards_reduce_to_the_whole_product(parallel):
    """Column-parallel: each rank's codes and scales are its output
    channels, the products concatenate. Row-parallel: its input rows with
    the whole scales, the products sum: ``sum_k (x_k @ q_k) * s``."""
    gen = torch.Generator().manual_seed(7)
    k, n, tp = 256, 96, 2
    w = torch.randn((1, k, n), generator=gen)
    x = torch.randn((5, k), generator=gen)
    qt = tq.quantize_int8(w, out_dtype='float32')
    spec = tsh.P(None, None, 'model') if parallel == 'column' else tsh.P(None, 'model', None)
    parts = []
    for rank in range(tp):
        local = tsh.shard_leaf(qt, spec, rank_mesh(rank, model=tp))[0]
        x_rank = x if parallel == 'column' else x[:, rank * k // tp:(rank + 1) * k // tp]
        if parallel == 'column':
            assert torch.equal(local.scale, qt.scale[0][:, rank * n // tp:(rank + 1) * n // tp])
        else:
            assert torch.equal(local.scale, qt.scale[0])
        parts.append(tqm.int8_dense(x_rank, local.q, local.scale, backend='reference'))
    got = torch.cat(parts, dim=-1) if parallel == 'column' else sum(parts)
    want = tqm.int8_dense(x, qt.q[0], qt.scale[0], backend='reference')
    tol = tqm.comparison_tolerance(x, qt.q[0], qt.scale[0], route='cuda_cores')
    assert ((got - want).abs() <= tol).all()


def test_bank_scales_split_with_their_codes_and_nf4_slices_at_use():
    gen = torch.Generator().manual_seed(3)
    bank = torch.randn((2, 4, 32, 64), generator=gen)  # [L, E, in, out]
    q8 = tq.quantize_int8(bank, out_dtype='float32')
    specs = {'gate': tsh.P(None, 'expert', None, 'model'),
             'down': tsh.P(None, 'expert', 'model', None)}
    for rank in range(4):
        mesh = rank_mesh(rank, expert=2, model=2)
        e, m = mesh.coords['expert'], mesh.coords['model']
        col = tsh.shard_leaf(q8, specs['gate'], mesh)
        assert col.shape == (2, 2, 32, 32) and col.scale.shape == (2, 2, 1, 32)
        assert torch.equal(col.dequantize(),
                           q8.dequantize()[:, 2 * e:2 * e + 2, :, 32 * m:32 * m + 32])
        row = tsh.shard_leaf(q8, specs['down'], mesh)
        assert row.shape == (2, 2, 16, 64) and row.scale.shape == (2, 2, 1, 64)
        assert torch.equal(row.q, q8.q[:, 2 * e:2 * e + 2, 16 * m:16 * m + 16])
    nf4 = tq.quantize_nf4(bank[0], out_dtype='float32')  # [E, in, out]
    local = tsh.shard_leaf(nf4, tsh.P(None, None, 'model'), rank_mesh(1, model=2))
    assert local.q is nf4.q and local.shape == (4, 32, 32)
    assert torch.equal(local.dequantize(), nf4.dequantize()[..., 32:])
    assert torch.equal(local[1].dequantize(), nf4.dequantize()[1, :, 32:])


@pytest.mark.parametrize('family,quantization', [
    ('mistral', 'int8'), ('mistral', None), ('mixtral', 'int8'), ('mixtral', 'nf4'),
])
def test_sharded_init_is_the_slice_of_the_whole_init(family, quantization):
    module = {'mistral': mistral, 'mixtral': mixtral}[family]
    extra = dict(num_experts=4) if family == 'mixtral' else dict(attention_bias=True)
    cfg = _tiny(mixtral.MixtralConfig if family == 'mixtral' else mistral.MistralConfig,
                **extra)
    sizes = dict(expert=2, model=2) if family == 'mixtral' else dict(model=2)
    whole = module.init(cfg, torch.Generator().manual_seed(5), device='cpu',
                        quantization=quantization)
    specs = module.param_specs(cfg)
    for rank in range(int(np.prod(list(sizes.values())))):
        mesh = rank_mesh(rank, **sizes)
        direct = module.init(cfg, torch.Generator().manual_seed(5), device='cpu',
                             quantization=quantization,
                             leaf_fn=tsh.leaf_sharder(specs, mesh))
        want = tsh.shard_pytree(whole, specs, mesh)
        got_leaves, want_leaves = tq.leaves(direct), tq.leaves(want)
        assert len(got_leaves) == len(want_leaves)
        for got, ref in zip(got_leaves, want_leaves):
            if isinstance(ref, tq.QTensor):
                assert got.shape == ref.shape and got.view == ref.view
                assert torch.equal(got.q, ref.q) and torch.equal(got.scale, ref.scale)
            else:
                assert torch.equal(got, ref)


def test_global_numel_counts_replicated_leaves_once():
    cfg = _tiny(mistral.MistralConfig)
    whole = mistral.init(cfg, torch.Generator().manual_seed(0), device='cpu')
    specs = mistral.param_specs(cfg)
    total = sum(t.numel() for t in tq.leaves(whole))
    for rank in range(2):
        mesh = rank_mesh(rank, model=2)
        local = tsh.shard_pytree(whole, specs, mesh)
        assert tsh.global_numel(local, specs, mesh)[0] == total


# -------------------------------------------------------------- multihost
_TOPOLOGY_ENV = (
    'DISTLLM_JAX_COORDINATOR', 'DISTLLM_JAX_NUM_PROCESSES', 'DISTLLM_JAX_PROCESS_ID',
    'SLURM_PROCID', 'PMI_RANK', 'PALS_RANKID', 'MASTER_ADDR', 'MASTER_PORT', 'RANK',
    'WORLD_SIZE',
)


@pytest.mark.parametrize('env,args,want', [
    ({'DISTLLM_JAX_COORDINATOR': 'h:1', 'DISTLLM_JAX_NUM_PROCESSES': '4',
      'DISTLLM_JAX_PROCESS_ID': '3', 'SLURM_PROCID': '1', 'RANK': '2'},
     (), ('tcp://h:1', 4, 3)),
    ({'DISTLLM_JAX_COORDINATOR': 'tcp://h:1', 'DISTLLM_JAX_NUM_PROCESSES': '4',
      'SLURM_PROCID': '1', 'PMI_RANK': '2'}, (), ('tcp://h:1', 4, 1)),
    ({'DISTLLM_JAX_COORDINATOR': 'h:1', 'DISTLLM_JAX_NUM_PROCESSES': '4',
      'PMI_RANK': '2', 'PALS_RANKID': '0'}, (), ('tcp://h:1', 4, 2)),
    ({'DISTLLM_JAX_COORDINATOR': 'h:1', 'DISTLLM_JAX_NUM_PROCESSES': '4',
      'PALS_RANKID': '0', 'RANK': '3'}, (), ('tcp://h:1', 4, 0)),
    ({'MASTER_ADDR': 'm', 'MASTER_PORT': '7', 'WORLD_SIZE': '2', 'RANK': '1'},
     (), ('tcp://m:7', 2, 1)),
    ({'MASTER_ADDR': 'm', 'WORLD_SIZE': '2', 'RANK': '1',
      'DISTLLM_JAX_COORDINATOR': 'h:1'}, ('tcp://a:9', 3, 0), ('tcp://a:9', 3, 0)),
])
def test_init_multihost_topology_precedence(monkeypatch, env, args, want):
    for var in _TOPOLOGY_ENV:
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    assert multihost.resolve_topology(*args) == want


def test_init_multihost_refusals_and_idempotence(monkeypatch):
    for var in _TOPOLOGY_ENV:
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match='process_id'):
        multihost.resolve_topology('h:1', 2)
    with pytest.raises(ValueError, match="backend='nccl'"):
        multihost.init_multihost('h:1', 1, 0)
    assert multihost.process_rank() == (0, 1)
    address = f'localhost:{multihost.free_port()}'
    try:
        assert multihost.init_multihost(address, 1, 0, backend='gloo', timeout_s=30) == (0, 1)
        assert multihost.init_multihost('elsewhere:1', 5, 3, backend='nccl') == (0, 1)
        mesh = tmesh.make_mesh(tmesh.MeshSpec(data=1), devices=['cpu'])
        assert mesh.backend == 'gloo' and mesh.size == 1 and mesh.num_devices == 1
        x = torch.arange(4.0)
        assert torch.equal(comm.TensorParallel(mesh).gather_model(x), x)
    finally:
        torch.distributed.destroy_process_group()
    assert multihost.process_rank() == (0, 1)


_JOIN = textwrap.dedent(
    """
    import json, sys
    import torch
    from distllm_tpu_torch.parallel import comm, mesh, multihost
    rank, size = multihost.init_multihost(backend='gloo', timeout_s=60)
    m = mesh.make_mesh(mesh.MeshSpec(data=1, model=2), devices='cpu')
    tp = comm.TensorParallel(m)
    summed = tp.reduce_model(torch.tensor([rank + 1.0]))
    gathered = tp.gather_model(torch.tensor([10.0 * rank, 10.0 * rank + 1]))
    print(json.dumps({'rank': rank, 'size': size, 'coords': m.coords,
                      'sum': summed.tolist(), 'gathered': gathered.tolist(),
                      'devices': m.num_devices,
                      'process_rank': list(multihost.process_rank())}))
    torch.distributed.destroy_process_group()
    """
)


def test_two_processes_join_from_the_pod_environment():
    """The rendered pod scripts' variables (coordinator, process count,
    the scheduler rank as the process id) join two processes; each
    makes the mesh over gloo, and the model group's all-reduce and gather
    see both."""
    import json

    port = multihost.free_port()
    env = {k: v for k, v in os.environ.items() if k not in _TOPOLOGY_ENV}
    env.update(DISTLLM_JAX_COORDINATOR=f'localhost:{port}', DISTLLM_JAX_NUM_PROCESSES='2',
               PYTHONPATH=str(REPO))
    procs = [
        subprocess.Popen([sys.executable, '-c', _JOIN], env={**env, 'SLURM_PROCID': str(r)},
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)
    ]
    outs = []
    for proc in procs:
        out, err = proc.communicate(timeout=90)
        assert proc.returncode == 0, err
        outs.append(json.loads(out.strip().splitlines()[-1]))
    for rank, out in enumerate(sorted(outs, key=lambda o: o['rank'])):
        assert out['rank'] == rank and out['size'] == 2 and out['process_rank'] == [rank, 2]
        assert out['coords']['model'] == rank
        assert out['sum'] == [3.0]
        assert out['gathered'] == [0.0, 1.0, 10.0, 11.0]
        assert out['devices'] == 1  # two ranks on one host's CPU: one device
