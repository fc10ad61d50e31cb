"""The decode window runner (``generate.engine.decode_graph``) on the CPU,
where it runs the captured step's function eagerly over its static
buffers — the buffer, carry and counter logic a CUDA graph replays on the
card.

- The port's engine, which serves every decode window through the runner,
  gives fp32 greedy tokens identical to the JAX ``LLMEngine`` (tolerance:
  identity) with per-request budgets that end mid-window, with recompute
  preemption, and with a stop token.
- ``mistral.decode_window_step`` iterated over the runner's buffers gives
  ``mistral.decode_loop``'s tokens, last ids and pool writes bitwise, and
  the JAX ``decode_loop``'s greedy tokens exactly and its pool within the
  fp32 tolerance of ``tests/test_torch_mistral.py`` (``atol 1e-5``,
  ``rtol 1e-4``); pools are compared outside the trash block 0, whose
  dead-row writes land on duplicate indices.
- ``LLMEngine.warmup`` leaves the scheduler's free blocks, every pool block
  but the trash block 0, ``stats['generated_tokens']`` and seeded sampled
  streams as they were (fp32 model; model-dtype and int8 pools).
- The replay accounting: a capture takes back what the wrappers counted
  and each replay adds it once (a fake graph object stands in for
  ``torch.cuda.CUDAGraph``).
"""

from contextlib import nullcontext

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distllm_tpu.generate.engine import EngineConfig as JaxEngineConfig
from distllm_tpu.generate.engine import LLMEngine as JaxLLMEngine
from distllm_tpu.generate.engine import SamplingParams as JaxSamplingParams
from distllm_tpu.models import mistral as jax_mistral
from distllm_tpu_torch.generate.engine import (
    EngineConfig,
    LLMEngine,
    SamplingParams,
)
from distllm_tpu_torch.generate.engine import decode_graph
from distllm_tpu_torch.models import mistral
from distllm_tpu_torch.ops import paged_attention as tpa
from distllm_tpu_torch.ops import quantized_matmul as tqm

TINY = {
    'vocab_size': 128, 'hidden_size': 32, 'num_layers': 2, 'num_heads': 4,
    'num_kv_heads': 2, 'intermediate_size': 64, 'dtype': 'float32',
}
ENGINE = {
    'block_size': 4, 'max_num_seqs': 3, 'max_model_len': 64, 'decode_steps': 4,
}
ATOL, RTOL = 1e-5, 1e-4


class _Tok:
    eos_id = None


@pytest.fixture(scope='module')
def weights():
    jcfg = jax_mistral.MistralConfig(**TINY)
    tree = jax.tree.map(np.asarray, jax_mistral.init(jax.random.PRNGKey(0), jcfg))
    tcfg = mistral.MistralConfig(**TINY)
    return jcfg, tree, tcfg, mistral.params_from_jax(tree, tcfg, device='cpu')


@pytest.fixture(scope='module')
def prompts():
    rng = np.random.default_rng(3)
    return [
        [int(t) for t in rng.integers(4, 128, size=n)]
        for n in (3, 11, 6, 17, 9)
    ]


def _port_engine(weights, num_blocks, **engine):
    _, _, tcfg, params = weights
    return LLMEngine(
        tcfg, params, _Tok(), EngineConfig(num_blocks=num_blocks, **{**ENGINE, **engine}),
        device='cpu',
    )


def _jax_generate(weights, prompts, params, num_blocks):
    """The JAX engine on per-request sampling params (its ``generate_ids``
    takes one for all), stop tokens stripped as ``generate_ids`` strips."""
    jcfg, tree, _, _ = weights
    engine = JaxLLMEngine(
        jcfg, tree, _Tok(),
        JaxEngineConfig(
            num_blocks=num_blocks, attn_backend='xla',
            prefer_native_allocator=False, **ENGINE,
        ),
    )
    rids = [engine.add_request(p, sp) for p, sp in zip(prompts, params)]
    engine._run_to_completion()
    outs = []
    for rid in rids:
        request = engine._finished.pop(rid)
        out = list(request.output_ids)
        if out and out[-1] in request.params.stop_token_ids:
            out = out[:-1]
        outs.append(out)
    engine.shutdown()
    return outs


# Per-request budgets that end inside a 4-step window (5, 2, 9, 6, 3).
BUDGETS = (5, 2, 9, 6, 3)


@pytest.mark.parametrize('case', ['budgets', 'preemption', 'stop'])
def test_engine_windows_on_the_runner_match_the_jax_engine(
    weights, prompts, case, monkeypatch,
):
    """Every decode window goes through the runner (``decode_loop`` is
    never called by the engine); fp32 greedy tokens equal the JAX
    engine's."""
    def not_called(*args, **kwargs):
        raise AssertionError('the engine must decode through its runner')

    monkeypatch.setattr(mistral, 'decode_loop', not_called)
    num_blocks = 12 if case == 'preemption' else 48
    budgets = BUDGETS if case == 'budgets' else (7,) * len(prompts)
    stops = [()] * len(prompts)
    if case == 'stop':
        free_run = _jax_generate(
            weights, prompts,
            [JaxSamplingParams(temperature=0.0, max_tokens=n) for n in budgets], 48,
        )
        # Each request's third token stops it (mid-window, after a window).
        stops = [(out[2],) for out in free_run]
    want = _jax_generate(weights, prompts, [
        JaxSamplingParams(temperature=0.0, max_tokens=n, stop_token_ids=s)
        for n, s in zip(budgets, stops)
    ], num_blocks)
    engine = _port_engine(weights, num_blocks)
    got = engine.generate_ids(prompts, [
        SamplingParams(temperature=0.0, max_tokens=n, stop_token_ids=s)
        for n, s in zip(budgets, stops)
    ])
    assert got == want
    assert engine.stats['decode_windows'] > 0
    assert engine.stats['decode_graph_replays'] == 0  # the CPU runs eagerly
    assert engine.sched.num_free_blocks == num_blocks - 1
    if case == 'budgets':
        assert [len(o) for o in got] == list(BUDGETS)
    if case == 'preemption':
        assert engine.stats['preemptions'] > 0
    if case == 'stop':
        assert all(len(o) < 7 for o in got)


def _window_inputs(tcfg, rng, b=3, max_blocks=6, block_size=4, nb=24):
    """Random pools and a window of ``b`` rows with ragged contexts; one
    row runs out of budget mid-window and one is dead from the start."""
    shape = (tcfg.num_layers, nb, block_size, tcfg.num_kv_heads, tcfg.head_size)
    k = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    perm = rng.permutation(np.arange(1, nb))[: b * max_blocks]
    bt = perm.reshape(b, max_blocks).astype(np.int32)
    pos = np.asarray([9, 4, 13], np.int32)[:b]
    return {
        'k': k, 'v': v, 'bt': bt,
        'ids': rng.integers(4, tcfg.vocab_size, size=b).astype(np.int32),
        'pos': pos, 'ctx': pos + 1,
        'steps_left': np.asarray([6, 3, 0], np.int32)[:b],
    }


@pytest.mark.parametrize('sampled', [False, True])
def test_step_iterated_equals_decode_loop_and_the_jax_loop(weights, sampled):
    jcfg, tree, tcfg, params = weights
    rng = np.random.default_rng(7)
    w = _window_inputs(tcfg, rng)
    b, steps = len(w['ids']), 6
    temp = np.asarray([0.0, 0.9, 0.7] if sampled else [0.0] * 3, np.float32)
    top_p = np.asarray([1.0, 0.9, 1.0], np.float32)
    min_p = np.zeros(b, np.float32)
    top_k = np.asarray([0, 0, 5], np.int32)
    seeds = np.asarray([11, 12, 13], np.int64)

    def t(x):
        return torch.from_numpy(np.array(x))

    pools_loop = (t(w['k']), t(w['v']))
    tokens, _, _, last_ids = mistral.decode_loop(
        params, tcfg, t(w['ids']), t(w['pos']), *pools_loop, t(w['bt']),
        t(w['ctx']), t(w['steps_left']), t(temp), t(top_p), t(min_p), t(top_k),
        t(seeds), num_steps=steps, max_table_positions=64, all_greedy=not sampled,
    )
    pools_run = (t(w['k']), t(w['v']))
    runner = decode_graph.DecodeGraphRunner(
        params, tcfg, *pools_run, max_num_seqs=b, max_blocks_per_seq=w['bt'].shape[1],
        decode_steps=8, max_table_positions=64, attn_backend='auto',
        device=torch.device('cpu'),
    )
    assert runner.ready
    runner.load(w['ids'], w['pos'], w['ctx'], w['bt'], w['steps_left'], temp,
                top_p, min_p, top_k, seeds)
    ran = runner.run(steps, all_greedy=not sampled)
    buf = runner.buffers
    assert ran.shape == (steps, b) and ran.dtype == torch.int32
    assert int(buf['step']) == steps
    for row, budget in enumerate(w['steps_left']):
        live = min(int(budget), steps)
        assert torch.equal(ran[:live, row], tokens[:live, row])
        # The carry advanced by the live steps only.
        assert int(buf['positions'][row]) == w['pos'][row] + live
        assert int(buf['context_lens'][row]) == w['ctx'][row] + live
        assert int(buf['steps_left'][row]) == budget - steps
    assert torch.equal(buf['ids'], last_ids)
    for ours, theirs in zip(pools_run, pools_loop):
        assert torch.equal(ours[:, 1:], theirs[:, 1:])
    # The inputs of decode_loop stay as they were.
    assert np.array_equal(w['pos'], np.asarray([9, 4, 13], np.int32))
    if sampled:
        return
    jt, jk, jv, _ = jax_mistral.decode_loop(
        tree, jcfg, jnp.asarray(w['ids']), jnp.asarray(w['pos']),
        jnp.asarray(w['k']), jnp.asarray(w['v']), jnp.asarray(w['bt']),
        jnp.asarray(w['ctx']), jnp.asarray(w['steps_left']), jnp.asarray(temp),
        jnp.asarray(top_p), jnp.asarray(min_p), jnp.asarray(top_k),
        jnp.asarray(seeds.astype(np.uint32)), num_steps=steps,
        max_table_positions=64,
    )
    jt = np.asarray(jt)
    for row, budget in enumerate(w['steps_left']):
        live = min(int(budget), steps)
        np.testing.assert_array_equal(ran[:live, row].numpy(), jt[:live, row])
    for ours, theirs in zip(pools_run, (jk, jv)):
        np.testing.assert_allclose(
            ours[:, 1:].numpy(), np.asarray(theirs)[:, 1:], atol=ATOL, rtol=RTOL
        )


def test_runner_refuses_a_window_longer_than_its_buffer(weights):
    engine = _port_engine(weights, 16)
    with pytest.raises(ValueError, match='num_steps'):
        engine._decode.run(ENGINE['decode_steps'] + 1, all_greedy=True)
    with pytest.raises(ValueError, match='num_steps'):
        engine._decode.run(0, all_greedy=True)


@pytest.mark.parametrize('kv_cache_dtype', ['auto', 'int8'])
def test_warmup_leaves_state_and_sampled_streams_alone(weights, prompts, kv_cache_dtype):
    """The contract the JAX ``test_warmup_covers_paged_prefill_without_
    state_damage`` pins for the JAX engine, asserted on the port."""
    engine = _port_engine(weights, 48, kv_cache_dtype=kv_cache_dtype)
    greedy = SamplingParams(temperature=0.0, max_tokens=6)
    first = engine.generate_ids(prompts[:3], greedy)  # fills pool blocks
    free = engine.sched.num_free_blocks
    generated = engine.stats['generated_tokens']
    kv = engine.kv

    def pool():
        if engine.kv.quantized:
            return [x.clone() for pair in (kv.k, kv.v) for x in pair]
        return [kv.k.clone(), kv.v.clone()]

    before = pool()
    calls = tpa.ragged_paged_attention_reference.launches
    engine.warmup()
    # One eager step of each kind ran (greedy and sampled), every layer.
    assert tpa.ragged_paged_attention_reference.launches - calls == 2 * TINY['num_layers']
    assert engine.sched.num_free_blocks == free == 48 - 1
    assert engine.sched.num_running == 0
    assert engine.stats['generated_tokens'] == generated
    for old, new in zip(before, pool()):
        assert torch.equal(old[:, 1:], new[:, 1:])  # all but the trash block
    assert engine.generate_ids(prompts[:3], greedy) == first
    sampled = [SamplingParams(temperature=0.9, top_p=0.9, max_tokens=6, seed=s)
               for s in (1, 2)] + [SamplingParams(temperature=0.8, max_tokens=6)]
    fresh = _port_engine(weights, 48, kv_cache_dtype=kv_cache_dtype)
    warmed = _port_engine(weights, 48, kv_cache_dtype=kv_cache_dtype)
    warmed.warmup()
    assert warmed.generate_ids(prompts[:3], sampled) == fresh.generate_ids(
        prompts[:3], sampled
    )


class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_replays_add_the_captured_counts_once_each(weights):
    """The real step on the CPU ticks the plain versions' counters; a fake
    kernel step ticks the kernels' int and dict counters, and a dict
    rebound after the capture (as ``chip_smoke.py`` resets its counts)
    still receives each replay's share."""
    engine = _port_engine(weights, 16)
    runner = engine._decode
    runner._load_trash()
    before = decode_graph.read_counters()
    runner._step(True)
    eager = decode_graph.counter_delta(before, decode_graph.read_counters())
    assert eager[3] == TINY['num_layers']  # the plain attention op

    graph = _FakeGraph()
    before = decode_graph.read_counters()
    captured = decode_graph.capture_step(lambda: runner._step(True), graph, nullcontext())
    assert decode_graph.read_counters() == before  # a capture launches nothing
    assert captured.delta == eager
    for _ in range(5):
        captured.replay()
    assert graph.replays == 5
    assert decode_graph.counter_delta(before, decode_graph.read_counters()) == [
        {k: 5 * n for k, n in d.items()} if isinstance(d, dict) else 5 * d
        for d in eager
    ]

    kernel = tpa.ragged_paged_attention
    qmm = tqm.int8_matmul

    def fake_kernel_step():
        for _ in range(3):
            kernel.launches += 1
            kernel.launches_by_route['split_kv'] += 1
            kernel.launches_by_kv['int8'] += 1
        qmm.launches += 7
        qmm.launches_by_route['tensor_cores'] += 7

    before = decode_graph.read_counters()
    captured = decode_graph.capture_step(fake_kernel_step, _FakeGraph(), nullcontext())
    assert decode_graph.read_counters() == before
    kernel.launches = 0
    kernel.launches_by_route = dict.fromkeys(tpa.ROUTES, 0)
    kernel.launches_by_kv = dict.fromkeys(tpa.KV_MODES, 0)
    qmm.launches = 0
    qmm.launches_by_route = dict.fromkeys(tqm.ROUTES, 0)
    for _ in range(4):
        captured.replay()
    assert kernel.launches == 12
    assert kernel.launches_by_route == {
        'cuda_cores': 0, 'tensor_cores': 0, 'split_kv': 12, 'wgmma': 0,
    }
    assert kernel.launches_by_kv == {'model': 0, 'int8': 12, 'mixed': 0}
    assert qmm.launches == 28
    assert qmm.launches_by_route == {'cuda_cores': 0, 'tensor_cores': 28}


def test_a_failed_capture_leaves_the_counters_as_they_were():
    """What the wrappers counted before a capture raised was neither
    launched nor captured: the counters go back to where they were."""
    kernel = tpa.ragged_paged_attention

    def failing_step():
        kernel.launches += 2
        kernel.launches_by_route['split_kv'] += 2
        tqm.int8_matmul.launches += 7
        raise RuntimeError('capture failed')

    before = decode_graph.read_counters()
    with pytest.raises(RuntimeError, match='capture failed'):
        decode_graph.capture_step(failing_step, _FakeGraph(), nullcontext())
    assert decode_graph.read_counters() == before


def test_replay_accounting_covers_every_counter_of_the_kernel_modules():
    """Each ops module lists in ``COUNTERS`` every ``launches*`` counter
    its functions keep, and the runner adds them all back on replay."""
    from distllm_tpu_torch.ops import encoder_attention as tea

    for module in (tpa, tqm, tea):
        kept = {
            (fn, name)
            for fn in vars(module).values() if callable(fn)
            for name in vars(fn) if name.startswith('launches')
        }
        assert kept and kept == set(module.COUNTERS), module.__name__
        assert set(module.COUNTERS) <= set(decode_graph.COUNTERS)


def test_split_tickets_grow_without_freeing_a_buffer_a_graph_holds(monkeypatch):
    """A captured graph holds the address of the tickets it saw: growing
    them adds a larger buffer and keeps every earlier one, unchanged; and
    growing while a stream captures raises, while a launch that fits the
    newest buffer gets it."""
    monkeypatch.setattr(tpa, '_split_tickets', {})
    capturing = [False]
    monkeypatch.setattr(torch.cuda, 'is_current_stream_capturing', lambda: capturing[0])
    cpu = torch.device('cpu')
    first = tpa._tickets(cpu, 8)
    assert tpa._tickets(cpu, 200) is first and first.numel() == 256
    second = tpa._tickets(cpu, 300)
    third = tpa._tickets(cpu, 1100)
    assert second.numel() == 512 and third.numel() == 1100
    made = tpa._split_tickets[cpu.index]
    assert [t is b for t, b in zip(made, (first, second, third))] == [True] * 3
    assert all(not t.any() for t in made)
    capturing[0] = True
    assert tpa._tickets(cpu, 1100) is third
    with pytest.raises(RuntimeError, match='inside a CUDA graph capture'):
        tpa._tickets(cpu, 1101)
    assert len(tpa._split_tickets[cpu.index]) == 3


def test_warmup_at_one_step_windows_stays_inside_the_token_buffer(weights, prompts):
    """At ``decode_steps=1`` the token buffer has one row: warm-up's two
    eager steps (greedy and sampled) each write row 0, and the engine then
    serves the JAX engine's tokens (the card's warm-up runs the same
    steps before its captures)."""
    engine = _port_engine(weights, 48, decode_steps=1)
    engine.warmup()
    assert int(engine._decode.buffers['step']) == 0
    greedy = [SamplingParams(temperature=0.0, max_tokens=n) for n in BUDGETS]
    assert engine.generate_ids(prompts, greedy) == _jax_generate(weights, prompts, greedy, 48)


def test_capture_holds_the_garbage_collector_off():
    """A capture runs with the collector disabled (collecting an
    unreachable engine's CUDA graph mid-capture would invalidate it) and
    restores its state after, also when the step raises."""
    import gc

    seen = []

    def step():
        seen.append(gc.isenabled())

    assert gc.isenabled()
    decode_graph.capture_step(step, _FakeGraph(), nullcontext())
    assert seen == [False] and gc.isenabled()

    def failing():
        raise RuntimeError('capture failed')

    with pytest.raises(RuntimeError, match='capture failed'):
        decode_graph.capture_step(failing, _FakeGraph(), nullcontext())
    assert gc.isenabled()
    gc.disable()
    try:
        decode_graph.capture_step(step, _FakeGraph(), nullcontext())
        assert not gc.isenabled()  # a caller's disabled collector stays so
    finally:
        gc.enable()
