"""Device-side batched sampling for the continuous-batching engine, port of
``tpunet/serve/sampling.py``.

``batched_sample`` chooses every slot's next token on the device in one
``[slots]``-wide computation, so only the chosen int tokens cross to the
host, never the ``[slots, V]`` logits.

Semantics are ``models.lm.filter_logits``'s (top-k truncation first,
then the nucleus over the renormalised post-top-k distribution) with
per-row parameters: every slot carries its own temperature, top_k, top_p
and seed. Greedy rows (temperature <= 0) are the exact ``argmax`` of the
raw float32 logits (the first index of the largest value, as
``np.argmax``), which keeps greedy serve output token-identical to
``models.lm.generate``.

Randomness is stateless and counter-based: row b's draw is the Gumbel-max
choice ``argmax(filtered logits / T + g)``, with the Gumbel noise ``g`` of
vocab index j a function of ``(seed_b, SALT, step_b, j)`` only, hashed in
int64 on the device (``step_b`` is how many tokens the request has
generated). So the stream is deterministic per ``(seed, step)``: the same
at any slot, with any batch partners, and continued exactly by a
preempted-and-resumed request. The hash is not JAX's PRNG, so a sampled
stream differs from tpunet's for the same seed; greedy streams are equal.

``batched_sample_positions`` draws every position of the speculative
verify's ``[slots, K+1]`` logits the same way, at consecutive steps.

JAX's ``lax.cond(any(temperature > 0))`` is the caller's decision here:
the engine knows its slots' temperatures on the host, and when no row
samples it takes the rows' argmax (what this function gives greedy rows)
without calling it.
"""

from __future__ import annotations

import torch

# Salt folded into every per-request key so the serve sample stream
# never collides with another stream built from the same user seed.
_SAMPLE_SALT = 0x5E12
_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finaliser (lowbias32) on int64 values in
    [0, 2^32): bijective, every output bit depends on every input bit.
    Products wrap in int64; the mask keeps their exact low 32 bits."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def gumbel_noise(seeds: torch.Tensor, steps: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """[B, vocab] float64 standard Gumbel noise, a pure function of each
    row's (seed, step) and the vocab index."""
    dev = seeds.device
    key = _mix32((seeds.to(torch.int64) & _M32) ^ _SAMPLE_SALT)
    key = _mix32(key ^ (steps.to(torch.int64) & _M32))               # [B]
    j = torch.arange(vocab, device=dev, dtype=torch.int64)
    h = _mix32(key[:, None] ^ _mix32(j + 0x9E3779B9)[None, :])       # [B,V]
    u = (h.to(torch.float64) + 0.5) * 2.0 ** -32                      # (0, 1)
    return -torch.log(-torch.log(u))


def filter_rows(logits: torch.Tensor, temperature: torch.Tensor,
                top_k: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """``logits`` [B, V] float32 over each row's temperature (rows at
    temperature <= 0 divide by 1), then each row's top-k and nucleus
    filters, ``filter_logits``' semantics: tokens outside them become
    -inf."""
    v = logits.shape[-1]
    hot = temperature > 0
    lg = logits / torch.where(hot, temperature,
                              torch.ones_like(temperature))[:, None]
    srt = torch.sort(lg, dim=-1, descending=True).values
    cols = torch.arange(v, device=logits.device)[None, :]
    # -- per-row top-k (filter_logits: keep lg >= the k-th largest) ---
    top_k = top_k.to(torch.int64)
    apply_k = ((top_k > 0) & (top_k < v))[:, None]
    kth = torch.gather(srt, 1, (top_k - 1).clamp(0, v - 1)[:, None])
    lg = lg.masked_fill(apply_k & (lg < kth), -torch.inf)
    srt = srt.masked_fill(apply_k & (cols >= top_k[:, None]), -torch.inf)
    # -- per-row nucleus over the renormalised post-top-k distribution --
    apply_p = ((top_p > 0.0) & (top_p < 1.0))[:, None]
    probs = torch.softmax(srt, dim=-1)
    keep = torch.cumsum(probs, dim=-1) - probs < top_p[:, None]
    cutoff = torch.where(keep, srt, torch.inf).amin(-1, keepdim=True)
    return lg.masked_fill(apply_p & (lg < cutoff), -torch.inf)


def batched_sample(logits: torch.Tensor, temperature: torch.Tensor,
                   top_k: torch.Tensor, top_p: torch.Tensor,
                   seeds: torch.Tensor, steps: torch.Tensor) -> torch.Tensor:
    """One token per row from ``logits`` [B, V] float32, int64 [B].

    ``temperature``/``top_p`` float32 [B], ``top_k``/``seeds``/``steps``
    int [B], all on the logits' device. Rows with ``temperature <= 0``
    are greedy argmax of the raw logits; the others draw from
    :func:`filter_rows` with the per-(seed, step) Gumbel-max draw."""
    lg = filter_rows(logits, temperature, top_k, top_p)
    noise = gumbel_noise(seeds, steps, logits.shape[-1])
    draw = torch.argmax(lg.to(torch.float64) + noise, dim=-1)
    return torch.where(temperature > 0, draw, torch.argmax(logits, dim=-1))


def batched_sample_positions(logits: torch.Tensor, temperature: torch.Tensor,
                             top_k: torch.Tensor, top_p: torch.Tensor,
                             seeds: torch.Tensor,
                             steps0: torch.Tensor) -> torch.Tensor:
    """Per-position sampling for the speculative verify step, tpunet's
    ``batched_sample_positions``: one token per (row, position) of
    ``logits`` [B, T, V] float32, int64 [B, T].

    Position ``j`` of row ``b`` draws with step ``steps0[b] + j``, the
    step the sequential decode loop would have drawn at when it reached
    that position, which makes a sampled spec-on stream equal the
    spec-off stream per (seed, step) and keeps a failover resume
    deterministic. T reuses of the [B]-wide :func:`batched_sample`, so
    each draw sees the same computation as a decode step's."""
    cols = [batched_sample(logits[:, j], temperature, top_k, top_p, seeds,
                           steps0 + j) for j in range(logits.shape[1])]
    return torch.stack(cols, dim=1)
