"""The port's ``/debug/*`` routes against the JAX chat server's.

Both servers run over their package's fake generator on free localhost
ports (``tests/test_torch_server.py``'s ``both_servers``). For every
route — ``traces``, ``flight``, ``perfetto``, ``history`` (with a
``prefix``), ``slo``, ``bundle`` and ``xprof`` — and for the bad
parameters (a non-integer ``limit``, a non-finite ``seconds``) the status
codes and the JSON body keys are the JAX server's. The port's Perfetto
document passes the validator, its bundle directory holds the bundle,
and its ``xprof`` capture wrote a ``torch.profiler`` trace.
"""

import json
import re
import time
from pathlib import Path

from test_torch_server import ASK, CORS, _call, _same, both_servers  # noqa: F401

from distllm_tpu_torch.chat_server import KNOWN_PATHS
from distllm_tpu_torch.observability.perfetto import validate_trace_events

ROUTES = ('/debug/traces', '/debug/flight', '/debug/perfetto', '/debug/history',
          '/debug/slo', '/debug/bundle', '/debug/xprof')
# The JAX app's labelled paths (``known_paths`` in its ``create_app``).
JAX_KNOWN_PATHS = ('/v1/chat/completions', '/health', '/metrics', '/drain', '/loadinfo')


def _path_labels(base):
    """The ``path`` labels of the latency series in one ``/metrics`` scrape."""
    text = _call(base, 'GET', '/metrics')[2].decode()
    return set(re.findall(r'^distllm_http_request_duration_seconds_count\{path="([^"]*)"\}',
                          text, flags=re.M))


def test_debug_routes_match_the_jax_server(both_servers, tmp_path, monkeypatch):  # noqa: F811
    monkeypatch.setenv('DISTLLM_DEBUG_DIR', str(tmp_path))
    port, ref = both_servers()
    for base in (port, ref):
        assert _call(base, 'POST', '/v1/chat/completions', ASK)[0] == 200
    time.sleep(1.2)  # one history tick on each side
    # The JAX labels: its five paths, every other one (the debug routes
    # too) under 'other'. The first scrape on each side carries the five.
    assert KNOWN_PATHS == JAX_KNOWN_PATHS
    # ('other' may be there already from an earlier test in this process.)
    assert _path_labels(port) - {'other'} == _path_labels(ref) - {'other'} == set(
        JAX_KNOWN_PATHS)
    for path in ('/debug/traces?limit=5', '/debug/flight?limit=3', '/debug/perfetto',
                 '/debug/history?limit=4&prefix=distllm_http', '/debug/slo',
                 '/debug/traces?limit=x', '/debug/flight?limit=1.5',
                 '/debug/perfetto?limit=no', '/debug/history?limit=', '/debug/xprof?seconds=nan',
                 '/debug/xprof?seconds=inf'):
        got, want = _call(port, 'GET', path), _call(ref, 'GET', path)
        _same(got, want, CORS)
    flight = json.loads(_call(port, 'GET', '/debug/flight?limit=3')[2])
    assert len(flight['records']) <= 3 and flight['capacity'] >= 1
    history = json.loads(_call(port, 'GET', '/debug/history?prefix=distllm_http')[2])
    assert history['sampler_running'] and history['samples'] >= 1
    assert all(k.startswith('distllm_http') for k in history['series'])
    doc = json.loads(_call(port, 'GET', '/debug/perfetto')[2])
    assert validate_trace_events(doc) == []
    slo = json.loads(_call(port, 'GET', '/debug/slo')[2])
    assert slo['verdict'] in ('ok', 'warn', 'page') and 'sentinel' in slo
    got, want = _call(port, 'GET', '/debug/bundle'), _call(ref, 'GET', '/debug/bundle')
    _same(got, want)
    bundle = json.loads(got[2])
    assert Path(bundle['bundle_dir']).parent == tmp_path
    assert (Path(bundle['bundle_dir']) / 'meta.json').exists()
    assert set(bundle['paths']) >= {'flight', 'metrics', 'traces', 'history', 'slo', 'meta'}
    # The debug requests above count under 'other', alike on both sides.
    assert _path_labels(port) == _path_labels(ref) == {*JAX_KNOWN_PATHS, 'other'}
    got, want = (_call(b, 'GET', '/debug/xprof?seconds=0.2') for b in (port, ref))
    body = json.loads(got[2])
    assert got[0] == 200 and body['ok'], body
    assert set(body) == set(json.loads(want[2]))
    assert set(body['state']) == set(json.loads(want[2])['state'])
    assert json.load(open(Path(body['trace_dir']) / 'trace.json'))['traceEvents']
