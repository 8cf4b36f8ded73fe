"""Transformer float graphs: BERT, ViT and a GPT-2-style decoder (port of
`tachikoma_tpu/models/transformer.py`).

The same functions with the same seeded random weights (numpy's
`default_rng`) as the JAX package, so the graphs are equal node for node and
byte for byte.  Built directly on the graph builder; `fuse_attention`
(ir/transforms.py) turns each attention subgraph into one `tk.attention`.
"""

from __future__ import annotations

import numpy as np

from ..ir.graph import Graph, GraphBuilder
from ..ir.infer import infer_types


def _rng(seed):
    return np.random.default_rng(seed)


def _dense(b, x, cin, cout, rng, name, bias=True):
    w = (rng.standard_normal((cin, cout)) * (cin ** -0.5)).astype(np.float32)
    y = b.call("nn.dense", x, b.const(w, name=f"{name}_w"), name=name)
    if bias:
        bb = b.const((rng.standard_normal(cout) * 0.02).astype(np.float32), name=f"{name}_b")
        y = b.call("nn.bias_add", y, bb, name=f"{name}_biased")
    return y


def _layer_norm(b, x, dim, rng, name):
    g = b.const(np.ones(dim, np.float32), name=f"{name}_g")
    beta = b.const(np.zeros(dim, np.float32), name=f"{name}_b")
    return b.call("nn.layer_norm", x, g, beta, axis=-1, epsilon=1e-12, name=name)


def _attention(b, x, batch, seq, dim, heads, rng, name):
    """Multi-head self-attention via batch_matmul (the qnn.batch_matmul trace
    path: reshape -> transpose -> Q@K^T -> softmax -> @V)."""
    hd = dim // heads
    q = _dense(b, x, dim, dim, rng, f"{name}_q")
    k = _dense(b, x, dim, dim, rng, f"{name}_k")
    v = _dense(b, x, dim, dim, rng, f"{name}_v")

    def heads_split(t, nm, perm):
        t = b.call("reshape", t, newshape=(batch, seq, heads, hd), name=f"{nm}_r")
        return b.call("transpose", t, axes=perm, name=f"{nm}_t")

    qh = heads_split(q, f"{name}_qh", (0, 2, 1, 3))   # B,H,S,D
    # K stays (B,H,S,D): transpose_b folds the head transpose into the
    # contraction (no explicit (0,2,3,1) transpose node)
    kh = heads_split(k, f"{name}_kh", (0, 2, 1, 3))
    vh = heads_split(v, f"{name}_vh", (0, 2, 1, 3))   # B,H,S,D
    scores = b.call("nn.batch_matmul", qh, kh, transpose_b=True,
                    name=f"{name}_scores")
    scale = b.const(np.float32(1.0 / np.sqrt(hd)))
    scaled = b.call("multiply", scores, scale, name=f"{name}_scaled")
    att = b.call("nn.softmax", scaled, axis=-1, name=f"{name}_softmax")
    ctx = b.call("nn.batch_matmul", att, vh, name=f"{name}_ctx")
    ctx = b.call("transpose", ctx, axes=(0, 2, 1, 3), name=f"{name}_ctx_t")
    ctx = b.call("reshape", ctx, newshape=(batch, seq, dim), name=f"{name}_ctx_r")
    return _dense(b, ctx, dim, dim, rng, f"{name}_o")


def _encoder_layer(b, x, batch, seq, dim, heads, ffn_dim, rng, name, act="nn.gelu"):
    att = _attention(b, x, batch, seq, dim, heads, rng, f"{name}_attn")
    res1 = b.call("add", x, att, name=f"{name}_res1")
    ln1 = _layer_norm(b, res1, dim, rng, f"{name}_ln1")
    h = _dense(b, ln1, dim, ffn_dim, rng, f"{name}_ffn1")
    h = b.call(act, h, name=f"{name}_act")
    h = _dense(b, h, ffn_dim, dim, rng, f"{name}_ffn2")
    res2 = b.call("add", ln1, h, name=f"{name}_res2")
    return _layer_norm(b, res2, dim, rng, f"{name}_ln2")


def bert(
    batch_size=1, seq_len=128, hidden=768, layers=12, heads=12,
    ffn_dim=3072, vocab=30522, num_classes=2, seed=0,
) -> Graph:
    """BERT-base encoder + classifier head (token-ids input)."""
    rng = _rng(seed)
    b = GraphBuilder("bert")
    ids = b.var("input_ids", (batch_size, seq_len), "int32")
    tok_table = b.const(
        (rng.standard_normal((vocab, hidden)) * 0.02).astype(np.float32), name="tok_emb"
    )
    pos_table = b.const(
        (rng.standard_normal((seq_len, hidden)) * 0.02).astype(np.float32), name="pos_emb"
    )
    tok = b.call("take", tok_table, ids, axis=0, name="embed_tok")
    pos = b.call("reshape", pos_table, newshape=(1, seq_len, hidden), name="embed_pos")
    h = b.call("add", tok, pos, name="embed_sum")
    h = _layer_norm(b, h, hidden, rng, "embed_ln")
    for i in range(layers):
        h = _encoder_layer(b, h, batch_size, seq_len, hidden, heads, ffn_dim, rng, f"layer{i}")
    # [CLS] pooling
    cls = b.call("strided_slice", h, begin=(0, 0), end=(batch_size, 1), strides=(1, 1),
                 axes=(0, 1), name="cls_slice")
    cls = b.call("reshape", cls, newshape=(batch_size, hidden), name="cls")
    pooled = _dense(b, cls, hidden, hidden, rng, "pooler")
    pooled = b.call("tanh", pooled, name="pooler_tanh")
    logits = _dense(b, pooled, hidden, num_classes, rng, "classifier")
    return infer_types(b.build(logits))


def bert_base(batch_size=1, seq_len=128, seed=0) -> Graph:
    return bert(batch_size, seq_len, 768, 12, 12, 3072, seed=seed)


def vit(
    batch_size=1, image_size=224, patch=16, hidden=1024, layers=24, heads=16,
    ffn_dim=4096, num_classes=1000, seed=0,
) -> Graph:
    """ViT (default config = ViT-L/16)."""
    rng = _rng(seed)
    b = GraphBuilder("vit")
    x = b.var("data", (batch_size, image_size, image_size, 3), "float32")
    # patch embedding = conv(patch, stride patch)
    w = (rng.standard_normal((patch, patch, 3, hidden)) * 0.02).astype(np.float32)
    emb = b.call(
        "nn.conv2d", x, b.const(w, name="patch_w"),
        strides=(patch, patch), padding=(0, 0, 0, 0), name="patch_embed",
    )
    nseq = (image_size // patch) ** 2
    h = b.call("reshape", emb, newshape=(batch_size, nseq, hidden), name="tokens")
    # prepend CLS token
    cls_tok = b.const((rng.standard_normal((1, 1, hidden)) * 0.02).astype(np.float32), name="cls_token")
    cls_b = b.call("broadcast_to", cls_tok, shape=(batch_size, 1, hidden), name="cls_bcast")
    h = b.call("concatenate", cls_b, h, axis=1, name="with_cls")
    seq = nseq + 1
    pos = b.const((rng.standard_normal((1, seq, hidden)) * 0.02).astype(np.float32), name="pos_emb")
    h = b.call("add", h, pos, name="pos_add")
    for i in range(layers):
        h = _encoder_layer(b, h, batch_size, seq, hidden, heads, ffn_dim, rng, f"block{i}")
    h = _layer_norm(b, h, hidden, rng, "final_ln")
    cls = b.call("strided_slice", h, begin=(0, 0), end=(batch_size, 1), strides=(1, 1),
                 axes=(0, 1), name="cls_out_slice")
    cls = b.call("reshape", cls, newshape=(batch_size, hidden), name="cls_out")
    logits = _dense(b, cls, hidden, num_classes, rng, "head")
    return infer_types(b.build(logits))


def vit_l16(batch_size=1, image_size=224, seed=0) -> Graph:
    return vit(batch_size, image_size, 16, 1024, 24, 16, 4096, seed=seed)


def vit_b16(batch_size=1, image_size=224, seed=0) -> Graph:
    return vit(batch_size, image_size, 16, 768, 12, 12, 3072, seed=seed)


def _causal_attention(b, x, batch, seq, dim, heads, rng, name):
    """Decoder self-attention: additive causal mask (upper triangle at -30,
    deep enough that the integer softmax LUT maps masked scores to ~0 while
    staying inside a sane quantization range)."""
    hd = dim // heads
    q = _dense(b, x, dim, dim, rng, f"{name}_q")
    k = _dense(b, x, dim, dim, rng, f"{name}_k")
    v = _dense(b, x, dim, dim, rng, f"{name}_v")

    def heads_split(t, nm, perm):
        t = b.call("reshape", t, newshape=(batch, seq, heads, hd),
                   name=f"{nm}_r")
        return b.call("transpose", t, axes=perm, name=f"{nm}_t")

    qh = heads_split(q, f"{name}_qh", (0, 2, 1, 3))
    kh = heads_split(k, f"{name}_kh", (0, 2, 1, 3))
    vh = heads_split(v, f"{name}_vh", (0, 2, 1, 3))
    scores = b.call("nn.batch_matmul", qh, kh, transpose_b=True,
                    name=f"{name}_scores")
    scale = b.const(np.float32(1.0 / np.sqrt(hd)))
    scaled = b.call("multiply", scores, scale, name=f"{name}_scaled")
    mask = np.triu(np.full((seq, seq), -30.0, np.float32), 1)
    mc = b.const(mask.reshape(1, seq, seq), name=f"{name}_causal_mask")
    masked = b.call("add", scaled, mc, name=f"{name}_masked")
    att = b.call("nn.softmax", masked, axis=-1, name=f"{name}_softmax")
    ctx = b.call("nn.batch_matmul", att, vh, name=f"{name}_ctx")
    ctx = b.call("transpose", ctx, axes=(0, 2, 1, 3), name=f"{name}_ctx_t")
    ctx = b.call("reshape", ctx, newshape=(batch, seq, dim),
                 name=f"{name}_ctx_r")
    return _dense(b, ctx, dim, dim, rng, f"{name}_o")


def _decoder_layer(b, x, batch, seq, dim, heads, ffn_dim, rng, name):
    """Pre-LN (GPT-2 style) causal decoder block."""
    ln1 = _layer_norm(b, x, dim, rng, f"{name}_ln1")
    att = _causal_attention(b, ln1, batch, seq, dim, heads, rng,
                            f"{name}_attn")
    res1 = b.call("add", x, att, name=f"{name}_res1")
    ln2 = _layer_norm(b, res1, dim, rng, f"{name}_ln2")
    h = _dense(b, ln2, dim, ffn_dim, rng, f"{name}_ffn1")
    h = b.call("nn.gelu", h, name=f"{name}_act")
    h = _dense(b, h, ffn_dim, dim, rng, f"{name}_ffn2")
    return b.call("add", res1, h, name=f"{name}_res2")


def gpt2(batch_size=1, seq_len=128, hidden=768, layers=12, heads=12,
         ffn_dim=3072, vocab=50257, seed=0) -> Graph:
    """GPT-2-style decoder-only causal LM (pre-LN blocks, learned
    positions, weight-tied-shape LM head) — the autoregressive-LM family of
    the zoo (reference zoo has no decoder LM; this rounds out the model
    families for serving workloads)."""
    rng = _rng(seed)
    b = GraphBuilder("gpt2")
    ids = b.var("input_ids", (batch_size, seq_len), "int32")
    tok_table = b.const(
        (rng.standard_normal((vocab, hidden)) * 0.02).astype(np.float32),
        name="wte")
    pos_table = b.const(
        (rng.standard_normal((seq_len, hidden)) * 0.02).astype(np.float32),
        name="wpe")
    tok = b.call("take", tok_table, ids, axis=0, name="embed_tok")
    pos = b.call("reshape", pos_table, newshape=(1, seq_len, hidden),
                 name="embed_pos")
    h = b.call("add", tok, pos, name="embed_sum")
    for i in range(layers):
        h = _decoder_layer(b, h, batch_size, seq_len, hidden, heads,
                           ffn_dim, rng, f"block{i}")
    h = _layer_norm(b, h, hidden, rng, "ln_f")
    lm_w = b.const((rng.standard_normal((hidden, vocab)) * 0.02
                    ).astype(np.float32), name="lm_head")
    logits = b.call("nn.matmul", h, lm_w, name="logits")
    return infer_types(b.build(logits))


def gpt2_small(batch_size=1, seq_len=128, seed=0) -> Graph:
    return gpt2(batch_size, seq_len, 768, 12, 12, 3072, seed=seed)
