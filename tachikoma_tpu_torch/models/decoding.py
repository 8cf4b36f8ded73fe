"""Incremental (KV-cache) decoding for the causal-LM family, the serving path
(port of `tachikoma_tpu/models/decoding.py`).

Two static-shape programs serve a GPT-2:

  * the full causal graph (models/transformer.py gpt2) is the prefill and
    the recompute reference; through `fuse_attention` its attention runs on
    the flash-attention kernel (K6, causal);
  * gpt2_decode_step builds the per-token step graph: one token, a position
    scalar and the per-layer K/V caches in; the next token's logits and the
    updated caches out.  Cache writes are `dynamic_update_slice` at the
    position; attention runs over the whole cache under an additive position
    mask, so every shape is static and one step graph serves every token.

Weights are taken from the full graph's params (the same const names), so
incremental decoding and full recompute are the same model by construction.

`GreedyDecoder.generate` is the host loop: one step graph execution per
token, the caches kept on the device between steps and only the logits
brought to the host, where the token is chosen with numpy's seeded rng (the
JAX package's choice, draw for draw).  `generate_ondevice` is the port's form
of the JAX package's one jitted scan: on a CUDA device the step, the
token's choice and the caches' write-back are captured once in a CUDA graph
and replayed per token, and the host fetches the tokens once, at the end.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ir.graph import Graph, GraphBuilder
from ..ir.infer import infer_types


def gpt2_decode_step(full: Graph, batch_size=1, max_len=128, hidden=768,
                     layers=12, heads=12, ffn_dim=3072,
                     vocab=50257) -> Graph:
    """Build the single-token decode-step graph sharing `full`'s weights.

    Inputs : token (B,1) int32, pos () int32,
             k0..k{L-1}, v0..v{L-1}  (B,H,max_len,hd) float32
    Outputs: logits (B,vocab), then the updated caches in the same order.
    """
    P = full.params
    hd = hidden // heads
    b = GraphBuilder("gpt2_step")
    token = b.var("token", (batch_size, 1), "int32")
    pos = b.var("pos", (), "int32")
    kc = [b.var(f"k{i}", (batch_size, heads, max_len, hd), "float32")
          for i in range(layers)]
    vc = [b.var(f"v{i}", (batch_size, heads, max_len, hd), "float32")
          for i in range(layers)]

    def const(name):
        return b.const(P[name], name=name)

    def dense(x, prefix, cin, cout):
        y = b.call("nn.dense", x, const(f"{prefix}_w"))
        return b.call("nn.bias_add", y, const(f"{prefix}_b"))

    def layer_norm(x, prefix):
        return b.call("nn.layer_norm", x, const(f"{prefix}_g"),
                      const(f"{prefix}_b"), axis=-1, epsilon=1e-12)

    tok = b.call("take", const("wte"), token, axis=0)        # (B,1,H)
    pe = b.call("take", const("wpe"), pos, axis=0)           # (H,)
    pe = b.call("reshape", pe, newshape=(1, 1, hidden))
    h = b.call("add", tok, pe)

    zero = b.const(np.int32(0))
    # additive mask over cache positions: 0 where j <= pos, -30 beyond
    # (the full model's causal mask constant, transformer.py _causal_attention)
    ar = b.const(np.arange(max_len, dtype=np.int32), "step_arange")
    keep = b.call("less_equal", ar, pos)                     # (max_len,) bool
    mzero = b.const(np.zeros(max_len, np.float32))
    mneg = b.const(np.full(max_len, -30.0, np.float32))
    maskf = b.call("where", keep, mzero, mneg)               # (max_len,)
    maskf = b.call("reshape", maskf, newshape=(1, 1, 1, max_len))

    new_k, new_v = [], []
    for i in range(layers):
        pfx = f"block{i}"
        ln1 = layer_norm(h, f"{pfx}_ln1")
        q = dense(ln1, f"{pfx}_attn_q", hidden, hidden)
        k = dense(ln1, f"{pfx}_attn_k", hidden, hidden)
        v = dense(ln1, f"{pfx}_attn_v", hidden, hidden)

        def heads1(t):
            t = b.call("reshape", t, newshape=(batch_size, 1, heads, hd))
            return b.call("transpose", t, axes=(0, 2, 1, 3))  # (B,H,1,hd)

        qh, kh, vh = heads1(q), heads1(k), heads1(v)
        kcat = b.call("dynamic_update_slice", kc[i], kh, zero, zero, pos,
                      zero)
        vcat = b.call("dynamic_update_slice", vc[i], vh, zero, zero, pos,
                      zero)
        new_k.append(kcat)
        new_v.append(vcat)
        scores = b.call("nn.batch_matmul", qh, kcat, transpose_b=True)
        scale = b.const(np.float32(1.0 / np.sqrt(hd)))
        scaled = b.call("multiply", scores, scale)           # (B,H,1,L)
        masked = b.call("add", scaled, maskf)
        att = b.call("nn.softmax", masked, axis=-1)
        ctx = b.call("nn.batch_matmul", att, vcat)           # (B,H,1,hd)
        ctx = b.call("transpose", ctx, axes=(0, 2, 1, 3))
        ctx = b.call("reshape", ctx, newshape=(batch_size, 1, hidden))
        att_o = dense(ctx, f"{pfx}_attn_o", hidden, hidden)
        res1 = b.call("add", h, att_o)
        ln2 = layer_norm(res1, f"{pfx}_ln2")
        f1 = dense(ln2, f"{pfx}_ffn1", hidden, ffn_dim)
        act = b.call("nn.gelu", f1)
        f2 = dense(act, f"{pfx}_ffn2", ffn_dim, hidden)
        h = b.call("add", res1, f2)

    h = layer_norm(h, "ln_f")
    logits = b.call("nn.matmul", h, const("lm_head"))        # (B,1,V)
    logits = b.call("reshape", logits, newshape=(batch_size, vocab))
    return infer_types(b.build([logits] + new_k + new_v))


def _choose_on_device(logits: torch.Tensor, temperature: float, top_k: int | None,
                      gen: torch.Generator) -> torch.Tensor:
    """The next token (B,) int32, chosen on the logits' device: argmax, or
    top-k and temperature and a draw from `gen`."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    z = logits.to(torch.float32) / temperature
    if top_k:
        kth = torch.topk(z, top_k, dim=-1).values[:, -1:]
        z = torch.where(z < kth, torch.full_like(z, float("-inf")), z)
    p = torch.softmax(z, dim=-1)
    return torch.multinomial(p, 1, generator=gen).reshape(-1).to(torch.int32)


class GreedyDecoder:
    """Autoregressive generation over a decode-step graph.

    Each step is one execution of the same step graph (static shapes; the
    position is a scalar input), the serving hot loop.  `backend="torch"`
    runs it with a TorchExecutor on `device` ("cuda" by default: with no card
    it raises; pass device="cpu"); `backend="numpy"` runs the numpy
    interpreter on the host.
    """

    def __init__(self, step_graph: Graph, layers: int, backend: str = "torch",
                 device="cuda"):
        self.g = step_graph
        self.layers = layers
        self.backend = backend
        # the step's device (the torch backend's) and the prefill's; the
        # TorchExecutor raises for a card that is not there
        self.device = torch.device(device)
        self._prefill = None
        self.cuda_graph = None   # generate_ondevice's captured step, on a CUDA device
        self.replays = 0         # its replays in the last generate_ondevice
        self.step_seconds: list[float] = []  # host clock of each step of the last generate
        if backend == "torch":
            from ..runtime.executor import TorchExecutor

            self._ex = TorchExecutor(step_graph, device=self.device)
        elif backend == "numpy":
            from ..runtime.interpreter import Interpreter

            self._ex = None
            self._interp = Interpreter(step_graph)
        else:
            raise ValueError(f"unknown backend {backend!r}: 'torch' or 'numpy'")

    def _cache_shapes(self) -> dict:
        return {n.name: n.shape for n in self.g.inputs
                if n.name[0] in "kv" and n.name[1:].isdigit()}

    def _zero_caches(self) -> dict:
        shapes = self._cache_shapes()
        if self._ex is None:
            return {nm: np.zeros(sh, np.float32) for nm, sh in shapes.items()}
        return {nm: torch.zeros(sh, dtype=torch.float32, device=self.device)
                for nm, sh in shapes.items()}

    def _step(self, token: np.ndarray, pos: int, caches: dict):
        """One step: (logits (B, vocab) on the host, the new caches); its
        host-clock seconds, the logits' fetch included, go to step_seconds."""
        t0 = time.perf_counter()
        feeds = {"token": token, "pos": np.int32(pos), **caches}
        L = self.layers
        if self._ex is None:
            outs = self._interp.run(feeds)
            logits = np.asarray(outs[0])
        else:
            outs = self._ex.run_device(feeds)
            logits = outs[0].cpu().numpy()
        new = {f"k{i}": outs[1 + i] for i in range(L)}
        new.update({f"v{i}": outs[1 + L + i] for i in range(L)})
        self.step_seconds.append(time.perf_counter() - t0)
        return logits, new

    def _choose(self, logits: np.ndarray, temperature: float,
                top_k: int | None, rng) -> np.ndarray:
        if temperature <= 0:
            return np.argmax(logits, axis=-1).astype(np.int32)
        z = logits.astype(np.float64) / temperature
        if top_k:
            kth = np.partition(z, -top_k, axis=-1)[:, -top_k][:, None]
            z = np.where(z < kth, -np.inf, z)
        z = z - z.max(axis=-1, keepdims=True)
        p = np.exp(z)
        p /= p.sum(axis=-1, keepdims=True)
        return np.array([rng.choice(p.shape[-1], p=row) for row in p],
                        np.int32)

    def attach_prefill(self, full_graph: Graph):
        """One-pass prefill: run the FULL causal graph on the prompt and
        read the per-layer K/V head tensors out of its intermediate capture
        (transformer.py names them block{i}_attn_{kh,vh}_t; they remain
        after `fuse_attention`, feeding tk.attention), seeding the caches in
        a single graph execution instead of P step calls.  Runs on the
        decoder's device."""
        from ..runtime.executor import TorchExecutor

        names = []
        for i in range(self.layers):
            names += [f"block{i}_attn_kh_t", f"block{i}_attn_vh_t"]
        missing = [nm for nm in names if nm not in full_graph]
        if missing:
            raise ValueError(f"full graph lacks K/V head nodes: {missing}")
        self._prefill_len = full_graph.inputs[0].shape[1]
        self._prefill = TorchExecutor(full_graph, device=self.device,
                                      capture=[full_graph.outputs[0]] + names)
        return self

    def _run_prefill(self, prompt: np.ndarray, caches: dict) -> torch.Tensor:
        """The prefill over the right-padded prompt (causal masking makes the
        padding positions irrelevant), its K/V heads written into `caches`
        (in place); returns the full logits (B, S, vocab) on the device."""
        bsz, P = prompt.shape
        padded = np.zeros((bsz, self._prefill_len), np.int32)
        padded[:, :P] = prompt
        outs = self._prefill.run_device({self._prefill.graph.inputs[0].name: padded})
        for i in range(self.layers):
            for j, kv in enumerate("kv"):
                c = caches[f"{kv}{i}"]
                p_eff = min(P, c.shape[2])
                heads = outs[1 + 2 * i + j][:, :, :p_eff, :]
                if isinstance(c, np.ndarray):
                    c[:, :, :p_eff, :] = heads.cpu().numpy()
                else:
                    c[:, :, :p_eff, :] = heads
        return outs[0]

    def generate(self, prompt: np.ndarray, n_new: int,
                 temperature: float = 0.0, top_k: int | None = None,
                 seed: int = 0):
        """prompt (B, P) int32 -> (tokens (B, n_new) int32, logits list).

        temperature=0 is greedy; otherwise top-k/temperature sampling with
        a seeded host rng (deterministic serving)."""
        rng = np.random.default_rng(seed)
        bsz, P = prompt.shape
        caches = self._zero_caches()
        step_logits = []
        self.step_seconds = []
        if self._prefill is not None:
            full_logits = self._run_prefill(prompt, caches).cpu().numpy()
            step_logits = [full_logits[:, p, :] for p in range(P)]
            logits = full_logits[:, P - 1, :]
        else:
            # prefill token-by-token through the same step graph
            for p in range(P):
                logits, caches = self._step(prompt[:, p:p + 1], p, caches)
                step_logits.append(logits)
        toks = []
        cur = self._choose(logits, temperature, top_k, rng).reshape(bsz, 1)
        for s in range(n_new):
            toks.append(cur.copy())
            if s == n_new - 1:
                break
            logits, caches = self._step(cur, P + s, caches)
            step_logits.append(logits)
            cur = self._choose(logits, temperature, top_k,
                               rng).reshape(bsz, 1)
        return np.concatenate(toks, axis=1), step_logits

    def generate_ondevice(self, prompt: np.ndarray, n_new: int,
                          temperature: float = 0.0, top_k: int | None = None,
                          seed: int = 0) -> np.ndarray:
        """The whole decode loop on the device, fetched once at the end.

        The prefill seeds the caches; the token, the position (a 0-d int32
        tensor) and the caches live in static device buffers.  On a CUDA
        device one step (the step graph, the token's choice, the caches
        copied back into their buffers, the position advanced) is captured
        once in a CUDA graph, after one warm eager step that builds every
        per-node table and packed weight, and replayed per token
        (`self.cuda_graph`, `self.replays`).  A capture that fails raises:
        there is no eager fallback on a card.  On the CPU the same loop runs
        eagerly.  The choice is made on the device: argmax, or top-k,
        temperature and `torch.multinomial` from a `torch.Generator` seeded
        by `seed` (deterministic, but a different stream than the host
        loop's rng).  Greedy tokens equal `generate`'s.
        Returns tokens (B, n_new) int32."""
        if self._ex is None:
            raise ValueError("generate_ondevice requires the torch backend")
        bsz, P = prompt.shape
        L = self.layers
        shapes = self._cache_shapes()
        if self._prefill is None:
            raise ValueError("attach_prefill(...) first: on-device decode "
                             "seeds the caches in one prefill pass")
        # validate up front: a prompt longer than the attached prefill (or
        # the cache) would silently truncate the seeded cache
        min_cache = min(sh[2] for sh in shapes.values()) if shapes else 0
        if P > self._prefill_len or P > min_cache:
            raise ValueError(
                f"prompt length {P} exceeds the attached prefill length "
                f"({self._prefill_len}) or KV-cache length ({min_cache}); "
                f"re-attach a prefill built for at least {P} positions")
        dev = self.device
        caches = self._zero_caches()
        logits0 = self._run_prefill(prompt, caches)[:, P - 1, :]
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        tok = _choose_on_device(logits0, temperature, top_k, gen).reshape(bsz, 1)
        pos = torch.tensor(P, dtype=torch.int32, device=dev)
        order = [f"k{i}" for i in range(L)] + [f"v{i}" for i in range(L)]

        def step():
            outs = self._ex.run_device({"token": tok, "pos": pos, **caches})
            for nm, new in zip(order, outs[1:]):
                caches[nm].copy_(new)
            tok.copy_(_choose_on_device(outs[0], temperature, top_k, gen).reshape(bsz, 1))
            pos.add_(1)

        history = [tok.clone()]
        self.cuda_graph, self.replays = None, 0
        if dev.type == "cuda" and n_new > 1:
            graph = self._capture(step, tok, pos, caches, gen)
            for _ in range(n_new - 1):
                graph.replay()
                self.replays += 1
                history.append(tok.clone())
        else:
            for _ in range(n_new - 1):
                step()
                history.append(tok.clone())
        return torch.cat(history, dim=1).cpu().numpy().astype(np.int32)

    def _capture(self, step, tok, pos, caches, gen) -> torch.cuda.CUDAGraph:
        """`step` captured in a CUDA graph after one warm eager run of the
        step graph on a side stream (the run writes no buffer)."""
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._ex.run_device({"token": tok, "pos": pos, **caches})
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(gen)
        try:
            with torch.cuda.graph(graph):
                step()
        except RuntimeError as e:
            raise RuntimeError(f"generate_ondevice: the decode step could not be captured in "
                               f"a CUDA graph: {e}") from e
        self.cuda_graph = graph
        return graph


def gpt2_generate_scanned(full: Graph, prompt: np.ndarray, n_new: int, *,
                          max_len=128, hidden=768, layers=12, heads=12,
                          ffn_dim=3072, vocab=50257, temperature: float = 0.0,
                          top_k: int | None = None, seed: int = 0, device="cuda"):
    """Prefill and decode as one loop over token positions whose transformer
    body is one layer's math looped over the STACKED layer weights, in plain
    torch on `device`.  The JAX package wrote it as one jitted program for a
    remote compiler that capped a program's size; that reason does not hold
    here, and it is ported because callers (and tests) use it as the
    decoding reference that does not go through the step graph.

    The outer loop runs P + n_new - 1 single-token steps (teacher-forced
    over the prompt, then greedy or sampled); the inner loop runs the layers
    with the per-layer KV caches updated in place.  The layer math mirrors
    gpt2_decode_step op for op in float32 (exact gelu), so greedy tokens
    match GreedyDecoder's host loop.  Sampling draws from a torch.Generator
    seeded by `seed`.

    Returns tokens (B, n_new) int32."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' asked for but no CUDA device is available; "
                           "pass device='cpu' to run on the CPU")
    P_ = full.params
    hd = hidden // heads
    bsz, plen = prompt.shape
    assert plen + n_new <= max_len + 1, "prompt + generation exceeds max_len"

    # the stacked device weights, cached on the graph per device while its
    # params are the same arrays (replacing a param array invalidates it)
    params_token = tuple(sorted(id(v) for v in P_.values()))
    cache = full.__dict__.setdefault("_scan_gen_cache", {})
    ckey = (str(dev), layers, params_token)
    if ckey not in cache:
        def stack(fmt):
            return torch.from_numpy(np.stack([P_[fmt.format(i)] for i in range(layers)])).to(dev)

        stacked = {
            "ln1_g": stack("block{}_ln1_g"), "ln1_b": stack("block{}_ln1_b"),
            "ln2_g": stack("block{}_ln2_g"), "ln2_b": stack("block{}_ln2_b"),
            "q_w": stack("block{}_attn_q_w"), "q_b": stack("block{}_attn_q_b"),
            "k_w": stack("block{}_attn_k_w"), "k_b": stack("block{}_attn_k_b"),
            "v_w": stack("block{}_attn_v_w"), "v_b": stack("block{}_attn_v_b"),
            "o_w": stack("block{}_attn_o_w"), "o_b": stack("block{}_attn_o_b"),
            "f1_w": stack("block{}_ffn1_w"), "f1_b": stack("block{}_ffn1_b"),
            "f2_w": stack("block{}_ffn2_w"), "f2_b": stack("block{}_ffn2_b"),
        }
        tops = {k: torch.from_numpy(np.asarray(P_[k])).to(dev)
                for k in ("wte", "wpe", "ln_f_g", "ln_f_b", "lm_head")}
        # pin the keyed host arrays: their ids stay valid while cached
        cache[ckey] = (stacked, tops, list(P_.values()))
    stk, top, _ = cache[ckey]

    def ln(x, g, b):
        mu = x.mean(dim=-1, keepdim=True)
        var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + float(np.float32(1e-12))) * g + b

    def heads1(t):
        return t.reshape(bsz, 1, heads, hd).permute(0, 2, 1, 3)

    scale = torch.tensor(np.float32(1.0 / np.sqrt(hd)), device=dev)
    ar = torch.arange(max_len, device=dev)
    kc = torch.zeros((layers, bsz, heads, max_len, hd), dtype=torch.float32, device=dev)
    vc = torch.zeros_like(kc)
    prm = torch.from_numpy(prompt.astype(np.int64)).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    cur = torch.zeros(bsz, dtype=torch.int64, device=dev)
    toks = []
    for s in range(plen + n_new - 1):
        tok = prm[:, s] if s < plen else cur
        h = top["wte"].index_select(0, tok).reshape(bsz, 1, hidden) + top["wpe"][s]
        maskf = torch.where(ar <= s, 0.0, -30.0).to(torch.float32).reshape(1, 1, 1, max_len)
        for i in range(layers):
            x = ln(h, stk["ln1_g"][i], stk["ln1_b"][i])
            q = heads1(torch.matmul(x, stk["q_w"][i]) + stk["q_b"][i])
            kc[i, :, :, s:s + 1] = heads1(torch.matmul(x, stk["k_w"][i]) + stk["k_b"][i])
            vc[i, :, :, s:s + 1] = heads1(torch.matmul(x, stk["v_w"][i]) + stk["v_b"][i])
            scores = torch.matmul(q, kc[i].transpose(-1, -2)) * scale
            att = torch.softmax(scores + maskf, dim=-1)
            ctx = torch.matmul(att, vc[i]).permute(0, 2, 1, 3).reshape(bsz, 1, hidden)
            res1 = h + (torch.matmul(ctx, stk["o_w"][i]) + stk["o_b"][i])
            x = ln(res1, stk["ln2_g"][i], stk["ln2_b"][i])
            f1 = torch.matmul(x, stk["f1_w"][i]) + stk["f1_b"][i]
            act = torch.nn.functional.gelu(f1, approximate="none")
            h = res1 + (torch.matmul(act, stk["f2_w"][i]) + stk["f2_b"][i])
        logits = torch.matmul(ln(h, top["ln_f_g"], top["ln_f_b"]), top["lm_head"])
        cur = _choose_on_device(logits.reshape(bsz, vocab), temperature, top_k,
                                gen).to(torch.int64)
        if s >= plen - 1:
            toks.append(cur)
    return torch.stack(toks, dim=1).cpu().numpy().astype(np.int32)
