"""KV block-chain wire format — the port's copy of
``paddle_tpu/generation/kv_wire.py``, byte for byte the same format, so a
blob written by either package is read by the other.

A filled paged-KV block chain for a prompt crosses between engines as ONE
self-verifying blob:

    MAGIC (8 bytes)  b"PDKVW01\\n"
    HLEN  (4 bytes)  big-endian header length
    HEADER           JSON: schema version, the prefix-chain identity
                     (``sha256(int32 tokens[:covered])``, the stream
                     ``prefix_cache.PrefixCache`` keys chains by), the
                     covered token ids, block geometry, the per-layer
                     per-field dtype/shape spec, and the sha256 of the
                     payload bytes
    PAYLOAD          the raw C-contiguous bytes of every arena field of
                     every layer, concatenated in header order (keys and
                     values and, for int8 KV, the fp32 scale planes)

The receiver re-hashes the payload and re-validates the header before a
byte enters its pool, so a truncated, bit-flipped or magicless blob raises
the typed :class:`KVTransferCorrupt` (counted ``kv.transfer.corrupt``) and
the receiver prefills locally instead: a corrupt transfer can cost
latency, never a wrong token.

:func:`chain_digests` gives the prefix-chain identity stream (the digests
a router matches against :meth:`PrefixCache.hot_heads`).
"""
from __future__ import annotations

import hashlib
import json
from typing import List, Sequence, Tuple

import numpy as np

__all__ = ["KVTransferCorrupt", "MAGIC", "serialize_chain",
           "deserialize_chain", "chain_digests", "HEAD_HEX_CHARS"]

MAGIC = b"PDKVW01\n"

# registry-heartbeat digest truncation: 16 hex chars (64 bits) keeps
# the lease payload small; collisions only ever cost one misrouted
# dispatch (correctness never depends on the routing hint)
HEAD_HEX_CHARS = 16


class KVTransferCorrupt(RuntimeError):
    """A KV chain blob failed verification (bad magic, torn header,
    payload hash mismatch, or a geometry that does not match the
    receiving arenas).  Receivers treat it as a clean MISS: count it,
    drop the blob, re-prefill locally — never decode over suspect KV."""


def _corrupt(msg: str) -> KVTransferCorrupt:
    from ..profiler import metrics as _metrics
    _metrics.counter(
        "kv.transfer.corrupt",
        "KV chain blobs rejected at receive (bad magic / torn header / "
        "payload hash mismatch / geometry mismatch) — each one a clean "
        "local re-prefill, never a wrong-KV decode").inc()
    from ..profiler import flight as _flight
    if _flight.active:
        _flight.note("kv", "transfer_corrupt", error=msg)
    return KVTransferCorrupt(msg)


def chain_digests(tokens, block_size: int,
                  hexlen: int = HEAD_HEX_CHARS
                  ) -> List[Tuple[int, str]]:
    """``(ntokens, digest)`` pairs for every block-aligned prefix of
    ``tokens`` plus the partial tail — byte-identical to the sha256
    stream ``PrefixCache._key`` uses, truncated to ``hexlen`` hex
    chars (the registry-heartbeat advertisement format)."""
    toks = np.ascontiguousarray(tokens, dtype=np.int32).reshape(-1)
    raw = toks.tobytes()
    isz = toks.itemsize
    plen = int(toks.size)
    bs = int(block_size)
    out: List[Tuple[int, str]] = []
    if bs < 1:
        return out
    h = hashlib.sha256()
    pos = 0
    n = bs
    while n <= plen:
        h.update(raw[pos * isz:n * isz])
        pos = n
        out.append((n, h.hexdigest()[:hexlen]))
        n += bs
    if pos < plen:
        h.update(raw[pos * isz:plen * isz])
        out.append((plen, h.hexdigest()[:hexlen]))
    return out


def _host_array(f) -> np.ndarray:
    """A payload field as a numpy array (host tensors of the port's swap
    payload, or numpy arrays)."""
    if hasattr(f, "detach"):
        return f.detach().cpu().numpy()
    return np.asarray(f)


def serialize_chain(tokens, covered: int, block_size: int,
                    payload: Sequence[Tuple]) -> bytes:
    """Pack a swapped-out block chain into one verified blob.

    ``payload`` is what ``PagedGenerationSession.swap_out_blocks``
    returns: per-layer tuples of host tensors or arrays (keys and values
    and, for int8 KV, the scale planes), first axis = chain length.
    ``tokens`` are the ``covered`` prompt ids the chain holds."""
    toks = np.ascontiguousarray(tokens, dtype=np.int32).reshape(-1)
    covered = int(covered)
    if toks.size != covered:
        raise ValueError(
            f"serialize_chain: got {toks.size} tokens for "
            f"covered={covered}")
    layers = []
    body = []
    for fields in payload:
        specs = []
        for f in fields:
            arr = np.ascontiguousarray(_host_array(f))
            specs.append({"dtype": str(arr.dtype),
                          "shape": [int(d) for d in arr.shape]})
            body.append(arr.tobytes())
        layers.append(specs)
    raw = b"".join(body)
    header = {
        "v": 1,
        "key": hashlib.sha256(toks.tobytes()).hexdigest(),
        "tokens": toks.tolist(),
        "covered": covered,
        "block_size": int(block_size),
        "layers": layers,
        "payload_sha256": hashlib.sha256(raw).hexdigest(),
    }
    hdr = json.dumps(header, separators=(",", ":")).encode()
    return MAGIC + len(hdr).to_bytes(4, "big") + hdr + raw


def deserialize_chain(blob: bytes, *, expect_block_size=None,
                      expect_spec=None) -> dict:
    """Verify + unpack a :func:`serialize_chain` blob.

    Returns ``{"tokens": int32 array, "covered": int, "block_size":
    int, "payload": per-layer tuples of numpy arrays, "key": hex
    digest}`` — arrays bit-identical to what was serialized.  Raises
    :class:`KVTransferCorrupt` (counted) on ANY defect; a caller that
    sees the exception has received zero unverified bytes.

    ``expect_block_size`` / ``expect_spec`` (the receiving session's
    ``block_spec``) extend verification to the receiver's arena
    geometry, so a blob from a mismatched model/config is rejected as
    corrupt BEFORE any pool allocation."""
    if not isinstance(blob, (bytes, bytearray, memoryview)):
        raise _corrupt(f"blob must be bytes, got {type(blob).__name__}")
    blob = bytes(blob)
    if len(blob) < len(MAGIC) + 4:
        raise _corrupt(f"blob truncated to {len(blob)} bytes (no "
                       "magic + header length)")
    if blob[:len(MAGIC)] != MAGIC:
        raise _corrupt(f"bad magic {blob[:len(MAGIC)]!r} (expected "
                       f"{MAGIC!r})")
    hlen = int.from_bytes(blob[len(MAGIC):len(MAGIC) + 4], "big")
    hoff = len(MAGIC) + 4
    if hoff + hlen > len(blob):
        raise _corrupt(f"header claims {hlen} bytes but only "
                       f"{len(blob) - hoff} remain")
    try:
        header = json.loads(blob[hoff:hoff + hlen].decode())
    except (ValueError, UnicodeDecodeError) as e:
        raise _corrupt(f"torn header: {e}") from None
    if not isinstance(header, dict) or header.get("v") != 1:
        raise _corrupt(f"unsupported header version "
                       f"{header.get('v') if isinstance(header, dict) else header!r}")
    raw = blob[hoff + hlen:]
    want = header.get("payload_sha256")
    got = hashlib.sha256(raw).hexdigest()
    if got != want:
        raise _corrupt(f"payload hash mismatch: got {got[:16]}..., "
                       f"header says {str(want)[:16]}...")
    try:
        toks = np.asarray(header["tokens"], np.int32).reshape(-1)
        covered = int(header["covered"])
        block_size = int(header["block_size"])
        layers = header["layers"]
        if toks.size != covered or covered < 1 or block_size < 1:
            raise ValueError(
                f"{toks.size} tokens / covered={covered} / "
                f"block_size={block_size}")
        if hashlib.sha256(toks.tobytes()).hexdigest() != header["key"]:
            raise ValueError("chain key does not match tokens")
        payload = []
        off = 0
        for specs in layers:
            fields = []
            for spec in specs:
                dt = np.dtype(spec["dtype"])
                shape = tuple(int(d) for d in spec["shape"])
                n = int(np.prod(shape)) * dt.itemsize if shape \
                    else dt.itemsize
                arr = np.frombuffer(raw[off:off + n], dtype=dt)
                if arr.size != int(np.prod(shape)):
                    raise ValueError(
                        f"field needs {n} payload bytes at offset "
                        f"{off}, {len(raw) - off} remain")
                fields.append(arr.reshape(shape))
                off += n
            payload.append(tuple(fields))
        if off != len(raw):
            raise ValueError(f"{len(raw) - off} trailing payload "
                             "bytes beyond the declared fields")
        nblocks = (covered + block_size - 1) // block_size
        for li, fields in enumerate(payload):
            for f in fields:
                if f.shape[0] != nblocks:
                    raise ValueError(
                        f"layer {li} field holds {f.shape[0]} blocks "
                        f"but {covered} tokens need {nblocks}")
        if expect_block_size is not None \
                and block_size != int(expect_block_size):
            raise ValueError(
                f"chain block_size {block_size} != receiving pool "
                f"block_size {int(expect_block_size)}")
        if expect_spec is not None:
            got = [[(str(f.dtype), tuple(int(d) for d in f.shape[1:]))
                    for f in fields] for fields in payload]
            want = [[(str(np.dtype(d)), tuple(int(x) for x in s))
                     for d, s in layer] for layer in expect_spec]
            if got != want:
                raise ValueError(
                    f"chain arena geometry {got} does not match the "
                    f"receiving arenas {want}")
    except (KeyError, TypeError, ValueError) as e:
        raise _corrupt(f"invalid chain header/payload: {e}") from None
    return {"tokens": toks, "covered": covered,
            "block_size": block_size, "payload": payload,
            "key": header["key"]}
