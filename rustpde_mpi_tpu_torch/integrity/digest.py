"""On-device state digests and the deterministic one-bit flip.

Counterpart of the JAX package's ``integrity/digest.py``, bit for bit: the
same uint32 for the same arrays.  Each leaf's bit pattern is read as 32-bit
words (a float64 or int64 element as two words, low word first, as JAX's
``bitcast_convert_type`` gives them), each word is mixed with a hash of its
logical position, and the words are reduced by a wrapping sum and by an XOR;
the leaves fold in order with Knuth's multiplicative constant.

torch has few uint32 operations, so the words live in int64 tensors holding
values in ``[0, 2**32)``, masked to 32 bits after every product and sum
(the low 32 bits wrap as JAX's uint32 arithmetic does); a product by a
32-bit constant is split into its 16-bit halves so that no int64 product
overflows.  torch has no XOR reduction: the words are folded in halves with
``bitwise_xor``.  The positional mix depends on a leaf's shape only: a
captured digest builds it once (:func:`position_mixes`) and passes it in,
so the graph's owner keeps alive every tensor the graph reads.

The digest only reads the state, so a run steps the same with it on and off.
It is an error detector, not a cryptographic hash.
"""

from __future__ import annotations

import numpy as np
import torch

#: 2^32 / golden ratio, Knuth's multiplicative-hash constant (odd)
_GOLD = 0x9E3779B1
_KNUTH = 2654435761
#: the FNV-1a offset basis, the fold's seed
_SEED = 0x811C9DC5
_MIX = 1000003
_MASK = 0xFFFFFFFF


def _mul(a: torch.Tensor, c: int) -> torch.Tensor:
    """``a * c mod 2**32`` of int64 words in ``[0, 2**32)`` and a 32-bit
    constant, with no int64 product past 2**48."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _MASK


def _xor_reduce(words: torch.Tensor) -> torch.Tensor:
    """XOR of the last dim of ``words`` (folded in halves, zero-padded)."""
    while words.shape[-1] > 1:
        n = words.shape[-1]
        if n % 2:
            words = torch.nn.functional.pad(words, (0, 1))
            n += 1
        words = torch.bitwise_xor(words[..., : n // 2], words[..., n // 2:])
    return words[..., 0]


def _words(x: torch.Tensor) -> torch.Tensor:
    """The leaf's bit pattern as int64 words in ``[0, 2**32)``: one word a
    4-byte element, two (low, high: a trailing dim of 2) an 8-byte one, a
    zero-extended word a 2-byte one, 0/1 a bool."""
    if x.dtype == torch.bool:
        return x.to(torch.int64)
    size = x.element_size()
    if size == 8:
        w = x.contiguous().reshape(-1).view(torch.int32).reshape(*x.shape, 2)
    elif size == 4:
        w = x.contiguous().reshape(-1).view(torch.int32).reshape(x.shape)
    elif size == 2:
        return x.contiguous().reshape(-1).view(torch.int16).reshape(x.shape).to(torch.int64) & 0xFFFF
    else:
        raise TypeError(f"no digest of {x.dtype} leaves")
    return w.to(torch.int64) & _MASK


def _position_mix(shape: tuple, device: torch.device) -> torch.Tensor:
    """``h(i0, .., ik) * GOLD mod 2**32`` over a leaf's logical indices,
    ``h = (..(i0 * 1000003 + i1) * 1000003 + ..) + ik``."""
    h = None
    for d, n in enumerate(shape):
        view = [1] * len(shape)
        view[d] = n
        i = torch.arange(n, dtype=torch.int64, device=device).reshape(view)
        h = i if h is None else (_mul(h, _MIX) + i) & _MASK
    return _mul(h.expand(shape), _GOLD).contiguous()


def _word_shape(x: torch.Tensor, lead: int) -> tuple:
    """The shape of a leaf's words behind its ``lead`` member dims (of each
    part of a complex leaf): a trailing 2 for 8-byte elements, ``(1,)``
    for a scalar of 4 bytes or fewer."""
    real = x.real if x.is_complex() else x
    shape = tuple(x.shape[lead:])
    if x.dtype != torch.bool and real.element_size() == 8:
        shape += (2,)
    return shape or (1,)


def position_mixes(leaves, lead: int = 0) -> list:
    """The positional mix of each leaf, on the leaf's device: what
    :func:`digest_words` reads besides the leaves."""
    return [_position_mix(_word_shape(t, lead), t.device) for t in leaves]


def _leaf_digest(x: torch.Tensor, lead: int, mix: torch.Tensor) -> torch.Tensor:
    """The digest of one leaf (an int64 word in ``[0, 2**32)``), or of each
    entry of its first ``lead`` dims (members), as JAX's ``vmap`` of the
    leaf digest gives it; ``mix`` is its positional mix."""
    if x.is_complex():
        return (_mul(_leaf_digest(x.real, lead, mix), _GOLD)
                + _leaf_digest(x.imag, lead, mix)) & _MASK
    bits = _words(x)
    if bits.ndim == lead:
        bits = bits.unsqueeze(-1)
    mixed = torch.bitwise_xor(bits, mix)
    flat = mixed.reshape(*bits.shape[:lead], -1)
    s = flat.sum(dim=-1) & _MASK
    return (_xor_reduce(flat) + _mul(s, _KNUTH)) & _MASK


def digest_words(leaves, lead: int = 0, mixes=None) -> torch.Tensor:
    """The digest of a sequence of leaves as an int64 word (``lead``: one
    digest per entry of the leaves' first ``lead`` dims), on the leaves'
    device, with no host sync.  ``mixes``: the leaves'
    :func:`position_mixes` (built here when None)."""
    leaves = list(leaves)
    if mixes is None:
        mixes = position_mixes(leaves, lead)
    d = None
    for leaf, mix in zip(leaves, mixes):
        w = _leaf_digest(leaf, lead, mix)
        d = (_mul(torch.full_like(w, _SEED), _GOLD) + w) & _MASK if d is None \
            else (_mul(d, _GOLD) + w) & _MASK
    if d is None:
        raise ValueError("digest of an empty state")
    return d


def digest_tree(state, lead: int = 0) -> np.ndarray:
    """The uint32 digest of a state (a NamedTuple or a sequence of tensors
    or arrays; fields in order), as the JAX package's ``digest_tree`` gives
    it: a numpy uint32 scalar, or one per member with ``lead=1``."""
    leaves = [t if torch.is_tensor(t) else torch.as_tensor(np.asarray(t)) for t in state]
    return digest_words(leaves, lead).cpu().numpy().astype(np.uint32)


def default_flip_bit(dtype) -> int:
    """The most significant mantissa bit of the dtype's real part: flipping
    it is an O(1) relative error that stays finite (exponent and sign are
    untouched), invisible to the NaN and CFL checks."""
    real = torch.empty(0, dtype=dtype).real.dtype if dtype.is_complex else dtype
    return 51 if torch.empty(0, dtype=real).element_size() == 8 else 22


def flip_one_bit(arr: torch.Tensor, index: tuple, bit: int) -> torch.Tensor:
    """A copy of ``arr`` with one bit of one element flipped (in the real
    part of a complex array), on the array's device."""
    out = arr.clone()
    real = torch.view_as_real(out)[..., 0] if out.is_complex() else out
    ints = real.view(torch.int64 if real.element_size() == 8 else torch.int32)
    ints[tuple(index)] ^= (1 << int(bit)) if bit < ints.element_size() * 8 - 1 \
        else -(1 << int(bit))
    return out


def flip_state_bit(state, step: int, member: int | None = None, col: int | None = None,
                   bit: int | None = None):
    """Flip one spectral-coefficient bit of a state, at the position the
    JAX package's ``flip_state_bit`` picks: the leaf ``temp`` (else the
    first field), the row hashed from ``step``, the last axis ``col`` (or
    hashed), one member's slice with ``member``.  Returns ``(new_state,
    info)``."""
    name = "temp" if hasattr(state, "temp") else state._fields[0]
    arr = getattr(state, name)
    shape = arr.shape[1:] if member is not None else arr.shape
    c = int(col) if col is not None else int(step * 40503) % int(shape[-1])
    idx = [int(step * _KNUTH) % int(n) for n in shape[:-1]] + [c]
    if member is not None:
        idx = [int(member)] + idx
    if bit is None:
        bit = default_flip_bit(arr.dtype)
    info = {"leaf": name, "index": tuple(idx), "bit": int(bit), "member": member}
    return state._replace(**{name: flip_one_bit(arr, tuple(idx), int(bit))}), info
