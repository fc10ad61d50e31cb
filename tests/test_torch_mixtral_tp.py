"""Mixtral and the generator under tensor and expert parallelism, against
the JAX package (helpers shared with ``test_torch_engine_tp.py``).

- ``apply`` at ``expert=2, model=2`` (4 ranks: this process and three
  spawned, gloo on the CPU) against JAX ``apply`` within
  ``atol=rtol=1e-5``: the twin of ``tests/test_models.py``'s EP x TP test.
- Mixtral served at ``tensor_parallel_size`` 2 (the generator's mesh:
  widths sharded, every expert on every rank), greedy fp32 tokens
  identical to the JAX engine's, every rank holding the same tokens.
- A chat YAML's generator config at ``tensor_parallel_size: 2, device:
  cpu`` through ``get_generator``, the CLI's generation job, and ``python
  -m distllm_tpu_torch.chat_server`` on such a YAML: each from one
  command, the same text as at 1.
"""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import jax
import numpy as np
import torch
import yaml

from distllm_tpu.models import mixtral as jax_mixtral
from distllm_tpu_torch.models import mixtral
from distllm_tpu_torch.parallel import comm, mesh, multihost, sharding
from tests.test_torch_engine_tp import (
    MODEL,
    TIMEOUT_S,
    _assert_same_tokens_on_every_rank,
    _greedy,
    _jax_tokens,
    _prompts,
    _sharded,
)

REPO = Path(__file__).resolve().parent.parent
MIXTRAL = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
               intermediate_size=64, num_experts=4, experts_per_token=2, dtype='float32')


def _mixtral_apply_rank(conn, tcfg, tree, ids, mask):
    """One rank of the EP x TP ``apply``: its mesh, its slices, the bound
    forward (rank 0 runs it inline, the others spawned)."""
    rank_mesh = mesh.make_mesh(mesh.MeshSpec(data=1, expert=2, model=2),
                               devices=['cpu'] * 4, backend='gloo')
    local = sharding.shard_pytree(tree, mixtral.param_specs(tcfg, tree), rank_mesh)
    bound = comm.bind(tcfg, rank_mesh)
    out = mixtral.apply(local, bound, torch.as_tensor(ids), torch.as_tensor(mask))
    return rank_mesh.coords, local['layers']['gate']['kernel'].shape, out.numpy()


def test_mixtral_ep2_tp2_apply_matches_jax():
    """Experts over ``expert``, widths over ``model``, the router
    replicated: each of the 4 ranks computes its 2 experts' half-width
    slices, and the combine sums over the expert x model group."""
    jcfg = jax_mixtral.MixtralConfig(**MIXTRAL)
    jtree = jax_mixtral.init(jax.random.PRNGKey(2), jcfg)
    ids = np.arange(2 * 8).reshape(2, 8).astype(np.int32) % 64
    mask = np.ones((2, 8), np.int32)
    expected = np.asarray(jax_mixtral.apply(jtree, jcfg, ids, mask))
    tcfg = mixtral.MixtralConfig(**MIXTRAL)
    tree = mixtral.params_from_jax(jax.tree.map(np.asarray, jtree), tcfg, device='cpu')
    args = (tcfg, tree, ids, mask)
    ranks = multihost.RankGroup(4, _mixtral_apply_rank, args, backend='gloo',
                                timeout_s=TIMEOUT_S)
    try:
        mine = _mixtral_apply_rank(None, *args)
    finally:
        others = ranks.close()
    results = [mine] + others
    assert sorted((c['expert'], c['model']) for c, _, _ in results) == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    for coords, gate_shape, out in results:
        assert tuple(gate_shape) == (2, 2, 32, 32)
        np.testing.assert_allclose(out, expected, atol=1e-5, rtol=1e-5)


def test_tp2_mixtral_engine_matches_jax():
    """The generator's mesh (data=1, model=tp): widths sharded, every
    expert on every rank."""
    jcfg = jax_mixtral.MixtralConfig(**MIXTRAL)
    jtree = jax_mixtral.init(jax.random.PRNGKey(4), jcfg)
    prompts = _prompts(7, (5, 14, 9, 3), vocab=64)
    want = _jax_tokens(jcfg, jtree, prompts, 8)
    tcfg = mixtral.MixtralConfig(**MIXTRAL)
    sharded = _sharded(tcfg, mixtral.params_from_jax(jax.tree.map(np.asarray, jtree), tcfg,
                                                     device='cpu'))
    assert sharded.engine.params['layers']['gate']['kernel'].shape == (2, 4, 32, 32)
    assert _greedy(sharded.engine, prompts, 8) == want
    _assert_same_tokens_on_every_rank(sharded.close())


# -------------------------------------------------------------- generator
def test_generator_at_tp2_from_a_chat_yaml(tmp_path):
    """The chat YAML's generator config at ``tensor_parallel_size: 2`` on
    the CPU: this process is rank 0 and spawns rank 1, each drawing only
    its slices of the seeded weights; the text equals the one-rank
    generator's, and the ranks stop with the generator."""
    from distllm_tpu_torch.chat_server import load_app_config
    from distllm_tpu_torch.generate import get_generator

    model = {'name': 'mistral', **MODEL}
    generator_config = {
        'name': 'torch', 'temperature': 0.0, 'max_tokens': 6, 'num_blocks': 32,
        'max_num_seqs': 2, 'max_model_len': 64, 'device': 'cpu', 'model': model,
        'tensor_parallel_size': 2,
    }
    path = tmp_path / 'app.yaml'
    path.write_text(yaml.safe_dump({'system_prompt': '', 'generator_config': generator_config}))
    config, _ = load_app_config(str(path))
    assert config.tensor_parallel_size == 2
    prompts = ['w1 w2 w3', 'w40 w41 w42 w43 w44', 'w7']
    tp2 = get_generator(generator_config)
    one = get_generator({**generator_config, 'tensor_parallel_size': 1})
    assert tp2.engine.mesh.shape['model'] == 2
    assert tp2.engine.params['layers']['gate']['kernel'].shape == (2, 64, 64)
    assert tp2.generate(prompts) == one.generate(prompts)
    tp2.shutdown()
    one.shutdown()
    _assert_same_tokens_on_every_rank(tp2.rank_reports)


def test_generation_job_at_tp2_writes_what_tp1_writes(tmp_path):
    """The CLI's ``generate`` job (``distributed_generation.run_generation``)
    with a generator config at ``tensor_parallel_size: 2``: the same shards
    as at 1."""
    from distllm_tpu_torch import distributed_generation as port_job
    from tests.test_torch_generate_job import TINY, _example_config, _shards, _write_inputs

    _write_inputs(tmp_path, n_files=2)
    generator = {'name': 'tpu', 'model': dict(TINY), 'temperature': 0.0, 'max_tokens': 6,
                 'num_blocks': 64, 'max_num_seqs': 3, 'max_model_len': 64, 'seed': 0}
    outs = {}
    for tp in (1, 2):
        config = port_job.Config.from_yaml(_example_config(
            tmp_path, f'tp{tp}', prompt_config={'name': 'identity'},
            generator_config={**generator, 'tensor_parallel_size': tp}))
        assert port_job.run_generation(config, device='cpu') == 0
        outs[tp] = _shards(tmp_path / f'tp{tp}')
    assert outs[1] == outs[2] and len(outs[2]) == 2


def _post(port, body, timeout=60):
    req = urllib.request.Request(
        f'http://127.0.0.1:{port}/v1/chat/completions', data=json.dumps(body).encode(),
        headers={'Content-Type': 'application/json'},
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def test_chat_server_command_serves_at_tp2(tmp_path):
    """``python -m distllm_tpu_torch.chat_server --config app.yaml`` with
    ``tensor_parallel_size: 2`` on the CPU: one command, the rank spawned by
    the generator; the completion equals a one-rank server's, and the
    ranks stop with the server."""
    from distllm_tpu_torch.chat_server import ChatServer, load_app

    generator_config = {
        'name': 'torch', 'temperature': 0.0, 'max_tokens': 6, 'num_blocks': 32,
        'max_num_seqs': 2, 'max_model_len': 64, 'device': 'cpu',
        'model': {'name': 'mistral', **MODEL}, 'tensor_parallel_size': 2,
    }
    path = tmp_path / 'app.yaml'
    path.write_text(yaml.safe_dump({'system_prompt': '', 'generator_config': generator_config}))
    body = {'model': 'm', 'messages': [{'role': 'user', 'content': 'w3 w14 w15 w92'}]}
    port = multihost.free_port()
    proc = subprocess.Popen(
        [sys.executable, '-m', 'distllm_tpu_torch.chat_server', '--config', str(path),
         '--port', str(port), '--device', 'cpu'],
        cwd=REPO, env={**os.environ, 'PYTHONPATH': str(REPO)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        deadline = time.monotonic() + 120
        while True:
            assert proc.poll() is None, proc.stdout.read()
            try:
                with urllib.request.urlopen(f'http://127.0.0.1:{port}/health', timeout=5):
                    break
            except OSError:
                assert time.monotonic() < deadline, 'the server never answered /health'
                time.sleep(0.5)
        status, answer = _post(port, body)
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
    one_rank = load_app(str(path))
    one_rank.generator_config['tensor_parallel_size'] = 1
    generator = one_rank.build_generator(device='cpu')
    with ChatServer(generator, port=0) as server:
        want = _post(server.port, body)
    generator.shutdown()
    assert status == 200 and answer['choices'][0]['message']['content']
    assert answer['choices'][0]['message']['content'] == want[1]['choices'][0]['message']['content']
