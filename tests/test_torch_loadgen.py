"""The port's open-loop load generator against the JAX package's, on the CPU.

- ``build_workload`` gives the JAX arrivals exactly (several configs, the
  refusals alike); ``arrival_messages`` renders alike; ``LoadReport`` and
  ``HttpLoadReport`` flatten to the same fragments.
- ``run_loadgen`` drives a tiny fp32 Mistral engine on both sides through
  a *burst* schedule (every arrival at t = 0, so batches are fixed by
  admission order): the tokens of every request are the JAX engine's,
  the report's percentiles cover exactly this run's requests (the
  coordinated-omission re-anchor of ``t_enqueue`` included), and a replay
  with attribution off gives identical tokens.
- Under recovered faults the run reports its retries and recoveries; under
  admission control it reports the shed arrivals.
- ``run_http_loadgen`` replays a schedule against the port's chat server
  over ``http.client`` threads, streamed and plain answers alike.
"""

import dataclasses

import pytest

from distllm_tpu.generate import loadgen as jax_loadgen
from distllm_tpu.resilience import faults as jax_faults
from distllm_tpu_torch.chat_server import ChatServer
from distllm_tpu_torch.generate import loadgen
from distllm_tpu_torch.generate.generators.torch_backend import (
    FakeGenerator,
    FakeGeneratorConfig,
)
from distllm_tpu_torch.resilience import faults
from test_torch_observability import jax_engine, jax_tree, port_engine  # noqa: F401

CONFIGS = [
    dict(),
    dict(seed=3, num_requests=40, rate_rps=32.0, num_sessions=2, warm_fraction=0.9,
         prefix_tokens=8, prompt_tokens=(2, 9), output_tokens=(1, 5), vocab_size=64),
    dict(seed=0, num_requests=256, rate_rps=16.0, num_sessions=16, warm_fraction=0.6,
         prefix_tokens=64, prompt_tokens=(32, 192), output_tokens=(16, 96), vocab_size=32000),
    dict(temperature=0.7, top_p=0.9, num_sessions=0),
]
BURST = dict(seed=1, num_requests=10, rate_rps=50.0, num_sessions=2, warm_fraction=0.5,
             prefix_tokens=8, prompt_tokens=(2, 10), output_tokens=(2, 7), vocab_size=64)


@pytest.mark.parametrize('fields', CONFIGS, ids=range(len(CONFIGS)))
def test_build_workload_equals_jax(fields):
    port = loadgen.build_workload(loadgen.LoadgenConfig(**fields))
    ref = jax_loadgen.build_workload(jax_loadgen.LoadgenConfig(**fields))
    assert [dataclasses.astuple(a) for a in port] == [dataclasses.astuple(a) for a in ref]
    for a, b in zip(port[:5], ref[:5]):
        assert loadgen.arrival_messages(a) == jax_loadgen.arrival_messages(b)


def test_bad_workloads_refused_alike():
    for fields in (dict(num_requests=0), dict(rate_rps=0.0)):
        with pytest.raises(ValueError):
            loadgen.build_workload(loadgen.LoadgenConfig(**fields))
        with pytest.raises(ValueError):
            jax_loadgen.build_workload(jax_loadgen.LoadgenConfig(**fields))


def test_reports_flatten_alike():
    fields = dict(
        requests=4, tokens=20, elapsed_s=1.23456, offered_rps=3.3333, achieved_tok_s=16.2,
        percentiles={'ttft_p50': 0.1234567, 'tpot_p99': None},
        window_tok_s={'tok_s_p50': 12.345}, goodput_tokens=15, goodput_frac=0.75,
        slo_met=3, slo_missed=1, warm_prefix_hit_tokens=16, warm_requests=2, cold_requests=2,
        roofline={'decode': {'mfu': 0.1, 'bw_util': 0.5}}, shed_requests=1, shed_rate=0.25,
    )
    assert loadgen.LoadReport(**fields).to_fragment('x_') == (
        jax_loadgen.LoadReport(**fields).to_fragment('x_')
    )
    http = dict(requests=2, ok=1, rejected=1, retried=0, errors=0, elapsed_s=0.5,
                goodput_rps=2.0, percentiles={'ttft_p50': 0.25}, by_replica={},
                ttft_by_request=[0.25, None], statuses=[200, 429], contents=['a', None])
    assert loadgen.HttpLoadReport(**http).to_fragment('h_') == (
        jax_loadgen.HttpLoadReport(**http).to_fragment('h_')
    )


def _burst(mod):
    return [dataclasses.replace(a, at_s=0.0)
            for a in mod.build_workload(mod.LoadgenConfig(**BURST))]


def test_run_loadgen_tokens_equal_jax_on_a_burst(jax_tree):
    engine = port_engine(jax_tree, enable_prefix_cache=True, ttft_slo_s=60.0, decode_steps=4)
    jengine = jax_engine(jax_tree, enable_prefix_cache=True, ttft_slo_s=60.0, decode_steps=4)
    report = loadgen.run_loadgen(engine, _burst(loadgen))
    ref = jax_loadgen.run_loadgen(jengine, _burst(jax_loadgen))
    assert report.tokens_by_request == ref.tokens_by_request
    assert report.tokens == ref.tokens == sum(len(t) for t in report.tokens_by_request)
    # A burst adds every request before any prefill lands: no warm hits yet.
    assert report.warm_prefix_hit_tokens == ref.warm_prefix_hit_tokens
    assert (report.slo_met, report.goodput_tokens) == (ref.slo_met, ref.goodput_tokens)
    assert (report.requests, report.warm_requests) == (ref.requests, ref.warm_requests)
    assert report.failed_requests == report.shed_requests == 0
    assert set(report.percentiles) == set(ref.percentiles)
    assert all(v is not None and v >= 0 for v in report.percentiles.values())
    assert all(t is not None for t in report.ttft_by_request)
    assert set(report.roofline) == set(ref.roofline)
    assert set(report.to_fragment('p_')) == set(ref.to_fragment('p_'))
    assert not engine._finished  # the run popped its own requests
    engine.attribution = False
    off = loadgen.run_loadgen(engine, _burst(loadgen))
    assert off.tokens_by_request == report.tokens_by_request
    assert off.roofline == {}


def test_run_loadgen_reports_recovery_and_shedding(jax_tree):
    injector = faults.get_fault_injector()
    jax_faults.get_fault_injector().disarm()
    clean = loadgen.run_loadgen(port_engine(jax_tree), _burst(loadgen))
    injector.arm('dispatch', times=2, after=3)
    try:
        engine = port_engine(jax_tree, max_dispatch_retries=3, retry_backoff_s=0.0)
        chaos = loadgen.run_loadgen(engine, _burst(loadgen))
    finally:
        injector.disarm()
    assert chaos.tokens_by_request == clean.tokens_by_request
    assert chaos.window_retries == 2 and chaos.recoveries >= 1
    assert chaos.quarantined == chaos.failed_requests == 0
    shed_engine = port_engine(jax_tree, ttft_slo_s=2e-6, admission_control=True)
    shed = loadgen.run_loadgen(shed_engine, _burst(loadgen))
    assert 0 < shed.shed_requests < shed.requests
    assert shed.shed_rate == shed.shed_requests / shed.requests
    assert sum(1 for t in shed.tokens_by_request if t) == shed.requests - shed.shed_requests
    assert shed.ttft_by_request.count(None) == shed.shed_requests


def test_run_http_loadgen_against_the_chat_server():
    generator = FakeGenerator(FakeGeneratorConfig(response_template='ok {prompt}'))
    workload = [dataclasses.replace(a, at_s=0.02 * i)
                for i, a in enumerate(_burst(loadgen)[:6])]
    streams = [i % 3 == 0 for i in range(len(workload))]
    with ChatServer(generator) as server:
        report = loadgen.run_http_loadgen(
            f'http://127.0.0.1:{server.port}', workload, stream=streams, timeout_s=30.0,
        )
    assert report.ok == report.requests == len(workload)
    assert report.statuses == [200] * len(workload) and report.errors == 0
    for content, streamed in zip(report.contents, streams):
        if streamed:
            assert content.startswith('data: ') and content.endswith('data: [DONE]\n\n')
        else:
            assert content.startswith('ok ')
    assert all(t is not None and t >= 0 for t in report.ttft_by_request)
    assert set(report.percentiles) == {'ttft_p50', 'ttft_p95', 'ttft_p99'}
    with pytest.raises(ValueError):
        loadgen.run_http_loadgen('http://127.0.0.1:1', workload, stream=[True])
