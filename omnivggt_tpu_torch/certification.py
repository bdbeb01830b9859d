"""Persisted fast-mode certification verdicts (counterpart of
omnivggt_tpu/certification.py).

`certify_fast_modes` (models/omnivggt.py) runs up to ten probe forwards at
checkpoint load. This module keeps the verdict next to the checkpoint,
keyed by a content fingerprint of the weights plus the gates the ladder ran
with, so the second load of the same checkpoint costs one pass of hashing
over the file instead.

The certificate does not store `bounded_attn_logits`: that check
(utils/validation.qk_logit_bound) is weight arithmetic and runs on every
load.

The file format, its name and `CERT_VERSION` are the JAX package's, and a
certificate written by either package is read by the other
(tests/test_torch_serving.py shows both directions): the fingerprint is of
the checkpoint file, and the modes are config fields both packages share.
A verdict reached on one machine's arithmetic then vouches on the other's;
delete the file to certify anew.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
from typing import Optional

log = logging.getLogger(__name__)

# bumped when the ladder's candidate set, probe recipe or gate semantics
# change: an old certificate must not vouch for another procedure
CERT_VERSION = 2

# the probe-expensive config fields the ladder decides
MODE_FIELDS = ("head_dtype", "approx_gelu", "trunk_quant", "attn_quant",
               "head_quant")


def checkpoint_fingerprint(path: str) -> str:
    """Content fingerprint of a checkpoint file or directory.

    Files are hashed in full (blake2b, 8 MB chunks). Directories hash the
    manifest of (relative path, size) plus the full content of any file
    under 1 MB.
    """
    h = hashlib.blake2b(digest_size=16)
    if os.path.isdir(path):
        for root, dirs, files in os.walk(path):
            dirs.sort()
            for name in sorted(files):
                if name == CERT_BASENAME:
                    continue  # the certificate must not key on itself
                fp = os.path.join(root, name)
                rel = os.path.relpath(fp, path)
                size = os.path.getsize(fp)
                h.update(f"{rel}:{size};".encode())
                if size < 1 << 20:
                    with open(fp, "rb") as f:
                        h.update(f.read())
    else:
        with open(path, "rb") as f:
            while True:
                chunk = f.read(8 << 20)
                if not chunk:
                    break
                h.update(chunk)
    return h.hexdigest()


CERT_BASENAME = "certified.json"


def certificate_path(ckpt_path: str) -> str:
    if os.path.isdir(ckpt_path):
        return os.path.join(ckpt_path, CERT_BASENAME)
    return ckpt_path + ".certified.json"


def _modes(cfg) -> dict:
    return {k: getattr(cfg, k) for k in MODE_FIELDS}


def load_certificate(ckpt_path: str, base_cfg, gates: dict,
                     fingerprint: Optional[str] = None):
    """Return the certified config if a valid cached verdict exists.

    Valid means: same CERT_VERSION, same checkpoint content fingerprint,
    same gates (tolerances + probe shape), and the same pre-certification
    base modes (a caller forcing fp32 must not inherit an int8 verdict).
    Returns None on any mismatch or unreadable file.
    """
    path = certificate_path(ckpt_path)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            cert = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        log.warning("unreadable certificate %s (%s); re-certifying", path, e)
        return None
    if cert.get("version") != CERT_VERSION:
        return None
    if cert.get("gates") != gates:
        return None
    if cert.get("base") != _modes(base_cfg):
        return None
    if fingerprint is None:
        fingerprint = checkpoint_fingerprint(ckpt_path)
    if cert.get("fingerprint") != fingerprint:
        log.warning(
            "certificate %s does not match checkpoint contents; re-certifying",
            path,
        )
        return None
    modes = cert.get("modes", {})
    if set(modes) != set(MODE_FIELDS):
        return None
    log.info("fast modes restored from %s: %s", path, modes)
    return dataclasses.replace(base_cfg, **modes)


def save_certificate(ckpt_path: str, base_cfg, certified_cfg, gates: dict,
                     fingerprint: Optional[str] = None) -> Optional[str]:
    """Write the verdict next to the checkpoint. Returns the path, or None
    when the checkpoint location is not writable (the load still works, it
    probes again next time)."""
    if fingerprint is None:
        fingerprint = checkpoint_fingerprint(ckpt_path)
    cert = {
        "version": CERT_VERSION,
        "fingerprint": fingerprint,
        "gates": gates,
        "base": _modes(base_cfg),
        "modes": _modes(certified_cfg),
    }
    path = certificate_path(ckpt_path)
    try:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(cert, f, indent=2)
        os.replace(tmp, path)
    except OSError as e:
        log.warning("could not persist certificate at %s (%s)", path, e)
        return None
    return path
