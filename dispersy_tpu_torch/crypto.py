"""Member identities and dispersy-identity records (port of the key
derivation, ``Member``, ``MemberRegistry``, ``create_identities`` and
``verify_identities`` of ``dispersy_tpu/crypto.py``).

On the card a member is its row index and records carry no signatures:
authentication is structural (only row i authors member-i records).  This
module supplies the identity layer around that core: every row's keypair
is derived from (registry seed, row index) -- a Schnorr key over the RFC
3526 group-14 prime, in Python ints and hashlib, the same numbers as the
JAX package's ``ECCrypto.generate_key`` -- and its ``mid`` is the SHA1 of
the serialized public key.  ``create_identities`` publishes each masked
member's ``dispersy-identity`` record, whose payload is ``mid32`` (the
first four bytes of the mid); :func:`verify_identities` holds the stored
records against the derived keys.  Signing is not ported.

Deriving a key is one modular exponentiation ``G ** x mod P``.  The base
is fixed, so :func:`_g_pow` reads it from a table of ``G ** (j << 8w)``
(8-bit windows, made once): about 20 modular products a key for the
160-bit "very-low" exponents instead of a full square-and-multiply, the
same value.  Derivation runs for the masked rows only, as in the JAX
package: at 1M peers the hardened schedule's 16,384 authors.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from dispersy_tpu_torch.config import META_IDENTITY, CommunityConfig
from dispersy_tpu_torch.u32 import wide

# RFC 3526 MODP group 14: 2048-bit safe prime; g = 4 generates the
# order-q subgroup, q = (p - 1) / 2.
_P_HEX = (
    "FFFFFFFFFFFFFFFFC90FDAA22168C234C4C6628B80DC1CD129024E088A67CC74"
    "020BBEA63B139B22514A08798E3404DDEF9519B3CD3A431B302B0A6DF25F1437"
    "4FE1356D6D51C245E485B576625E7EC6F44C42E9A637ED6B0BFF5CB6F406B7ED"
    "EE386BFB5A899FA5AE9F24117C4B1FE649286651ECE45B3DC2007CB8A163BF05"
    "98DA48361C55D39A69163FA8FD24CF5F83655D23DCA3AD961C62F356208552BB"
    "9ED529077096966D670C354E4ABC9804F1746C08CA18217C32905E462E36CE3B"
    "E39E772C180E86039B2783A2EC07A28FB5C55DF06F4C52C9DE2BCBF695581718"
    "3995497CEA956AE515D2261898FA051015728E5A8AACAA68FFFFFFFFFFFFFFFF")
P = int(_P_HEX, 16)
Q = (P - 1) // 2
G = 4

# Exponent bit widths of the security levels.
SECURITY_LEVELS = {"very-low": 160, "low": 192, "medium": 256, "high": 384}
_PUB_WIDTH = (P.bit_length() + 7) // 8   # 256 bytes

_WINDOW = 8
_TABLE: list = []    # _TABLE[j][d] = G ** (d << (8 j)) mod P, made on use


def _h(*parts: bytes) -> int:
    dig = hashlib.sha256()
    for p in parts:
        dig.update(len(p).to_bytes(4, "big"))
        dig.update(p)
    return int.from_bytes(dig.digest(), "big")


def _g_pow(x: int) -> int:
    """``pow(G, x, P)`` for ``0 <= x < Q`` through the fixed-base table."""
    windows = (Q.bit_length() + _WINDOW - 1) // _WINDOW
    need = min(windows, (x.bit_length() + _WINDOW - 1) // _WINDOW)
    while len(_TABLE) < need:
        base = pow(G, 1 << (_WINDOW * len(_TABLE)), P)
        row = [1, base]
        for _ in range((1 << _WINDOW) - 2):
            row.append(row[-1] * base % P)
        _TABLE.append(row)
    out = 1
    for j in range(need):
        d = (x >> (_WINDOW * j)) & ((1 << _WINDOW) - 1)
        if d:
            out = out * _TABLE[j][d] % P
    return out


@dataclasses.dataclass(frozen=True)
class Key:
    security: str
    private: int | None
    public: int


def generate_key(security: str, seed: bytes) -> Key:
    """The keypair of ``seed`` at ``security`` (the JAX package's
    ``ECCrypto.generate_key`` with an explicit seed)."""
    if security not in SECURITY_LEVELS:
        raise ValueError(f"unknown security level {security!r}; "
                         f"choose from {sorted(SECURITY_LEVELS)}")
    bits = SECURITY_LEVELS[security]
    x = (_h(b"dispersy-tpu-key", security.encode(), seed)
         % (1 << bits)) | 1
    x %= Q
    return Key(security=security, private=x, public=_g_pow(x))


def key_to_bin(key: Key) -> bytes:
    """The public key's serialization (what a mid digests)."""
    return (b"TPSC" + key.security.encode().ljust(8, b"\0")
            + key.public.to_bytes(_PUB_WIDTH, "big"))


@dataclasses.dataclass(frozen=True)
class Member:
    """One member: its row ``index``, serialized public key, ``mid`` =
    SHA1(public key) and keypair."""
    index: int
    public_key: bytes
    mid: bytes
    key: Key

    @property
    def mid32(self) -> int:
        """The first four bytes of the mid, as the u32 payload of the
        member's dispersy-identity record."""
        return int.from_bytes(self.mid[:4], "big")


class MemberRegistry:
    """Row index -> Member, every keypair derived from (``seed``, row
    index), so any row resolves without stored key material."""

    def __init__(self, seed: bytes = b"dispersy-tpu",
                 security: str = "very-low"):
        self.seed = seed
        self.security = security
        self._cache: dict[int, Member] = {}

    def member(self, index: int) -> Member:
        if index not in self._cache:
            key = generate_key(self.security,
                               self.seed + int(index).to_bytes(8, "big"))
            pub = key_to_bin(key)
            m = Member(index=index, public_key=pub,
                       mid=hashlib.sha1(pub).digest(), key=key)
            self._cache[index] = m
        return self._cache[index]

    def mid32_of(self, rows) -> np.ndarray:
        """uint32 mid32 of each row index in ``rows``."""
        return np.array([self.member(int(i)).mid32 for i in rows], np.uint32)


def create_identities(state, cfg: CommunityConfig, registry: MemberRegistry,
                      mask=None):
    """Each masked member (default: every non-tracker) authors its
    dispersy-identity record, payload = its mid32, through
    ``engine.create_messages``.  Keys are derived for the masked rows
    only.  Needs ``cfg.identity_enabled``."""
    from dispersy_tpu_torch import engine
    if not cfg.identity_enabled:
        raise ValueError(
            "create_identities needs CommunityConfig.identity_enabled=True "
            "(it folds IDENTITY_PRIORITY into the serving and forward "
            "order)")
    n = cfg.n_peers
    if mask is None:
        mask = np.arange(n) >= cfg.n_trackers
    mask_np = (mask.cpu().numpy() if isinstance(mask, torch.Tensor)
               else np.asarray(mask)).astype(bool).reshape(n)
    rows = np.flatnonzero(mask_np)
    payload = np.zeros(n, np.int64)
    payload[rows] = registry.mid32_of(rows)
    dev = state.device
    return engine.create_messages(state, cfg,
                                  torch.from_numpy(mask_np).to(dev),
                                  META_IDENTITY,
                                  torch.from_numpy(payload).to(dev))


def verify_identities(state, cfg: CommunityConfig,
                      registry: MemberRegistry) -> float:
    """The fraction of stored dispersy-identity records whose mid32 is
    the claimed author's real key digest (1.0 when none is stored).  Keys
    are derived for the authors found in the stores only."""
    rows = state.store_meta == META_IDENTITY
    if not bool(rows.any()):
        return 1.0
    member = wide(state.store_member)[rows].cpu().numpy()
    payload = wide(state.store_payload)[rows].cpu().numpy()
    authors, inv = np.unique(member, return_inverse=True)
    valid = authors < cfg.n_peers
    want = np.zeros(authors.shape, np.int64)
    want[valid] = registry.mid32_of(authors[valid])
    ok = valid[inv] & (payload == want[inv])
    return float(np.mean(ok))
