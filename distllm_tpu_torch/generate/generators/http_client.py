"""JSON over HTTP through ``urllib.request`` for the network generator
backends (the JAX package's backends use ``requests``, which the port does
not need).

:func:`post_json` sends the body as ``requests.post(url, json=body)``
sends it (``json.dumps`` with ``allow_nan=False``, UTF-8) with the same
``Accept`` and ``Accept-Encoding`` headers, and returns the decoded JSON
of a 2xx answer. A 401 or 403 raises :class:`ApiAuthError`, another
status of 400 or more :class:`HttpStatusError` (the two outcomes
``requests``' ``raise_for_status`` separates for the callers). Only
``User-Agent`` and ``Connection`` differ on the wire: ``urllib.request``
closes each connection.
"""

from __future__ import annotations

import gzip
import json
import urllib.error
import urllib.request
import zlib

# What requests sends besides User-Agent and Connection.
_DEFAULT_HEADERS = {'Accept-Encoding': 'gzip, deflate', 'Accept': '*/*'}


class ApiAuthError(Exception):
    """HTTP 401/403 from the endpoint — retrying cannot help."""


class HttpStatusError(Exception):
    """A status of 400 or more other than 401/403 (``requests``'
    ``HTTPError`` message)."""

    def __init__(self, status: int, reason: str, url: str) -> None:
        kind = 'Client' if status < 500 else 'Server'
        super().__init__(f'{status} {kind} Error: {reason} for url: {url}')
        self.status = status


def _decode(raw: bytes, encoding: str | None) -> bytes:
    if encoding == 'gzip':
        return gzip.decompress(raw)
    if encoding == 'deflate':
        try:
            return zlib.decompress(raw)
        except zlib.error:
            return zlib.decompress(raw, -zlib.MAX_WBITS)
    return raw


def post_json(url: str, body: dict, headers: dict, timeout: float):
    """POST ``body`` as JSON and return the answer's decoded JSON."""
    data = json.dumps(body, allow_nan=False).encode('utf-8')
    request = urllib.request.Request(
        url, data=data, headers={**_DEFAULT_HEADERS, **headers}, method='POST'
    )
    try:
        with urllib.request.urlopen(request, timeout=timeout) as response:
            raw = _decode(response.read(), response.headers.get('Content-Encoding'))
    except urllib.error.HTTPError as exc:
        if exc.code in (401, 403):
            raise ApiAuthError(f'{exc.code} from {url}') from None
        raise HttpStatusError(exc.code, exc.reason, url) from None
    return json.loads(raw)


def get_ok(url: str, timeout: float) -> bool:
    """Whether a GET of ``url`` answers below 400."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as response:
            return response.status < 400
    except urllib.error.HTTPError:
        return False
