"""Plain PyTorch reference of DMT's ``mmoe_transformer_unbias``: the
parameter layout, the forward of training and of serving, and the loss.

It follows the published model (guyulongcs/CIKM2020_DMT
``DMT_code/model/mmoe_transformer_unbias``) at the rounding points of the
configuration: tables of at least ``table_bf16_threshold`` rows are
stored in bfloat16 and their rows pooled in bfloat16 with float32 sums;
everything else is float32 with TF32 off (``exact_matmul``).  Dropout in
training: each behaviour transformer of one encoder and one decoder block
draws one int32 seed from the step's generator and derives its masks from
a counter hash of (seed, site, example, row, column); the bias net draws
its masks from the same generator (``torch.rand``), after the
transformers.  The reference imports nothing of the program under test.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -(2.0 ** 32) + 1     # score of a masked key
LN_EPS = 1e-8
KERAS_EPS = 1e-7

IDS, WTS, LEN = "__ids", "__wts", "__len"   # batch keys: feature + suffix


def exact_matmul(tf32: bool = False) -> None:
    """float32 products in float32 (``tf32`` True: the TF32 control), and
    bfloat16 products summed in float32."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


# ---------------------------------------------------------------------------
# Parameter layout: (path, shape, dtype, init) with init ("uniform", limit)
# or ("const", value); paths name the leaves as the program's tree does
# ---------------------------------------------------------------------------

DENSE_LIMIT = 0.1 * math.sqrt(3.0)     # uniform with standard deviation 0.1


def _glorot(shape) -> tuple:
    return ("uniform", math.sqrt(6.0 / (shape[-2] + shape[-1])))


def _dense(path, n_in, n_out, init, bias):
    return [(path + ("w",), (n_in, n_out), "float32", init),
            (path + ("b",), (n_out,), "float32", ("const", bias))]


def _mlp(path, n_in, hidden, n_out, init, hidden_bias, out_bias):
    out, dim = [], n_in
    for i, h in enumerate(hidden):
        out += _dense(path + (f"layer{i}", "dense"), dim, h,
                      init((dim, h)), hidden_bias)
        dim = h
    if n_out:
        out += _dense(path + ("out", "dense"), dim, n_out, init((dim, n_out)),
                      out_bias)
    return out


def _block(path, d, f):
    out = []
    for name in ("q", "k", "v"):
        out += _dense(path + ("mha", name), d, d, _glorot((d, d)), 0.0)
    out += [(path + ("mha", "ln", "gamma"), (d,), "float32", ("const", 1.0)),
            (path + ("mha", "ln", "beta"), (d,), "float32", ("const", 0.0))]
    out += _dense(path + ("ff", "fc1"), d, f, _glorot((d, f)), 0.0)
    out += _dense(path + ("ff", "fc2"), f, d, _glorot((f, d)), 0.0)
    out += [(path + ("ff", "ln", "gamma"), (d,), "float32", ("const", 1.0)),
            (path + ("ff", "ln", "beta"), (d,), "float32", ("const", 0.0))]
    return out


def combiner_dim(conf) -> int:
    return conf.feature_dimension + sum(s.dim for s in conf.embeddings)


def interest_dim(conf) -> int:
    return conf.d_model * len(conf.attention_pairs)


def layout(conf) -> list:
    """Every parameter leaf of the model."""
    def dense_init(shape):
        return ("uniform", DENSE_LIMIT)

    out = []
    for name, (rows, dim) in conf.tables(conf.embeddings).items():
        out.append((("emb", name), (rows, dim),
                    "bfloat16" if conf.table_dtype_is_bf16(rows)
                    else "float32", _glorot((rows, dim))))
    d = conf.d_model
    for gi in range(len(conf.attention_pairs)):
        p = ("trans", f"seq{gi}")
        out.append((p + ("pos_learn",), (conf.maxlen_k, d), "float32",
                    _glorot((conf.maxlen_k, d))))
        for i in range(conf.blocks_encode):
            out += _block(p + ("enc", i), d, conf.d_ff)
        for i in range(conf.blocks_decode):
            out += _block(p + ("dec", i), d, conf.d_ff)
    n_in = combiner_dim(conf) + interest_dim(conf)
    for e in range(conf.num_experts):
        out += _mlp(("mmoe", "experts", e), n_in, conf.hidden_bottom, 0,
                    dense_init, 0.1, 0.0)
    for t in range(2):
        out += _dense(("mmoe", "gates", t), n_in, conf.num_experts,
                      dense_init(None), 0.1)
    for task in ("click", "order"):
        out += _mlp((task,), conf.hidden_bottom[-1], conf.hidden_task, 1,
                    dense_init, 0.1, 0.1)
    for name, (rows, dim) in conf.tables(conf.embeddings_bias).items():
        out.append((("bias_net", "emb", name), (rows, dim), "float32",
                    _glorot((rows, dim))))
    out += _mlp(("bias_net", "mlp"), sum(s.dim for s in conf.embeddings_bias),
                conf.hidden_bias, 1, _glorot, 0.0, 0.0)
    return out


def tree_set(tree, path, value) -> None:
    """Sets ``path`` of a nested dict/list tree, making the containers."""
    for i, key in enumerate(path[:-1]):
        nxt = path[i + 1]
        if isinstance(tree, list):
            while len(tree) <= key:
                tree.append(None)
            if tree[key] is None:
                tree[key] = [] if isinstance(nxt, int) else {}
            tree = tree[key]
        else:
            tree = tree.setdefault(key, [] if isinstance(nxt, int) else {})
    if isinstance(tree, list):
        while len(tree) <= path[-1]:
            tree.append(None)
    tree[path[-1]] = value


# ---------------------------------------------------------------------------
# Dropout masks of the one-block transformer: a counter hash
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
SITE_ENC_IN, SITE_ENC_PROBS, SITE_DEC_IN, SITE_DEC_PROBS = 0, 1, 2, 3


def _mul32(x, c):
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _lowbias32(x):
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def hash_mask(seed: int, site: int, B: int, rows: int, cols: int,
              rate: float, device) -> torch.Tensor:
    """[B, rows, cols] float32 keep-mask scaled by 1 / (1 - rate):
    element (b, r, c) is kept when the top 24 bits of
    ``h(h(h(seed + site * golden) ^ b) ^ (r << 16 | c))`` fall below
    ``(1 - rate) * 2**24``."""
    key = _lowbias32(torch.tensor((seed + site * _GOLDEN) & _MASK32,
                                  dtype=torch.int64, device=device))
    ex = _lowbias32(key ^ torch.arange(B, device=device))
    rc = ((torch.arange(rows, device=device)[:, None] << 16)
          | torch.arange(cols, device=device)[None, :])
    bits = _lowbias32(ex[:, None, None] ^ rc[None])
    keep = (bits >> 8) < int(round((1.0 - rate) * (1 << 24)))
    return torch.where(keep, torch.tensor(1.0 / (1.0 - rate), device=device),
                       torch.zeros((), device=device))


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------


class Lookups:
    """Row lookups of one forward.  A table of ``lazy`` is read through
    its step's union: ``grid[name]`` [U, D] float32 (the differentiated
    rows), ``ugroups[name]`` the ascending distinct groups and ``group``
    the rows of a group; a bfloat16 table is gathered in float32 and
    rounded to bfloat16 once, so its gradient sums in float32."""

    def __init__(self, lazy: Optional[dict] = None):
        self.lazy = lazy or {}

    def take(self, name: str, table: torch.Tensor, ids: torch.Tensor):
        flat = ids.reshape(-1).long().clamp(0, table.shape[0] - 1)
        lz = self.lazy.get(name)
        if lz is not None:
            p = lz["group"]
            slot = torch.searchsorted(lz["ugroups"], flat // p) * p + flat % p
            rows = lz["grid"].index_select(0, slot).to(table.dtype)
        elif table.dtype == torch.bfloat16 and table.requires_grad:
            rows = table.float().index_select(0, flat).to(table.dtype)
        else:
            rows = table.index_select(0, flat)
        return rows.reshape(*ids.shape, table.shape[1])


def presence(wts: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    pos = torch.arange(wts.shape[-1], device=wts.device)
    return (pos < lens[..., None]).to(wts.dtype)


def pool_mean(grid, wts, lens):
    """Mean of the present rows in the grid's type, zeros where none."""
    w = wts * presence(wts, lens)
    s = torch.einsum("bl,bld->bd", w.to(grid.dtype), grid)
    den = w.sum(dim=-1, keepdim=True).to(grid.dtype)
    return torch.where(den > 0, s / den.clamp(min=1e-12),
                       torch.zeros((), dtype=grid.dtype, device=grid.device))


def ts_bucket(raw, rows):
    b = torch.floor(torch.log2(raw.clamp(min=1).float())).to(torch.int32) + 1
    b = torch.where(raw <= 0, torch.zeros_like(b), b)
    return b.clamp(0, rows - 1)


# ---------------------------------------------------------------------------
# Transformer (one behaviour sequence)
# ---------------------------------------------------------------------------


def _heads(x, H):
    B, T, D = x.shape
    return x.reshape(B, T, H, D // H).transpose(1, 2)


def _merge(x):
    B, H, T, dh = x.shape
    return x.transpose(1, 2).reshape(B, T, H * dh)


def _ln(x, p):
    mean = x.mean(-1, keepdim=True)
    xc = x - mean
    return p["gamma"] * (xc * torch.rsqrt((xc * xc).mean(-1, keepdim=True)
                                          + LN_EPS)) + p["beta"]


def _lin(p, x):
    return x @ p["w"] + p["b"]


def _sub_block(p, x, kv, km, qm, dmp, H):
    """Attention (key mask ``km``; probability rows of absent queries
    zeroed by ``qm``; dropout ``dmp``) + residual + LN, then the FF + LN."""
    mha, ff = p["mha"], p["ff"]
    q, k, v = _lin(mha["q"], x), _lin(mha["k"], kv), _lin(mha["v"], kv)
    qh, kh = _heads(q, H), _heads(k, H)
    s = (qh @ kh.transpose(-1, -2)) * (1.0 / math.sqrt(qh.shape[-1]))
    s = torch.where(km[:, None, None, :] > 0, s,
                    torch.full((), NEG_INF, dtype=s.dtype, device=s.device))
    prob = torch.softmax(s, dim=-1)
    if qm is not None:
        prob = prob * qm[:, None, :, None]
    if dmp is not None:
        prob = prob * dmp
    h1 = _ln(_merge(prob @ _heads(v, H)) + x, mha["ln"])
    f = torch.relu(_lin(ff["fc1"], h1))
    return _ln(_lin(ff["fc2"], f) + h1, ff["ln"])


def interest(conf, p, seq, mask, tar, train, gen):
    """[B, d_model] state of one sequence: encoder over the positions,
    single-query decoder of the target item."""
    H, rate = conf.num_heads, conf.dropout
    scale = float(torch.tensor(math.sqrt(conf.d_model), dtype=seq.dtype))
    T = seq.shape[1]
    enc = seq * scale + p["pos_learn"][:T][None]
    dec = (tar * scale)[:, None, :]
    km = mask.float()
    masks = (None,) * 4
    if train and rate > 0.0:
        if len(p["enc"]) != 1 or len(p["dec"]) != 1:
            raise NotImplementedError("reference dropout covers one encoder "
                                      "and one decoder block")
        seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=gen,
                                 device=gen.device, dtype=torch.int32)[0])
        B, dev = seq.shape[0], seq.device
        masks = (hash_mask(seed, SITE_ENC_IN, B, T, conf.d_model, rate, dev),
                 hash_mask(seed, SITE_DEC_IN, B, 1, conf.d_model, rate, dev),
                 torch.stack([hash_mask(seed, SITE_ENC_PROBS * 16 + h, B, T,
                                        T, rate, dev) for h in range(H)], 1),
                 torch.stack([hash_mask(seed, SITE_DEC_PROBS * 16 + h, B, 1,
                                        T, rate, dev) for h in range(H)], 1))
        enc, dec = enc * masks[0], dec * masks[1]
    for blk in p["enc"]:
        enc = _sub_block(blk, enc, enc, km, km, masks[2], H)
    for blk in p["dec"]:
        dec = _sub_block(blk, dec, enc, km, None, masks[3], H)
    return dec[:, 0, :]


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


def _dropout(gen, x, rate):
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def forward(conf, params, batch, look: Lookups, *, train: bool,
            gen: Optional[torch.Generator] = None, with_bias: bool = True):
    """((click, order), bias) logits [B] (bias None without
    ``with_bias``).  ``batch`` holds ``features`` (normalized), and per id
    feature its ids, weights and lengths; u-side rows are per example."""
    emb = params["emb"]
    spec_of = {s.feature: s for s in conf.embeddings}
    cache, states = {}, []
    for gi, group in enumerate(conf.attention_pairs):
        first = group[0][0]
        mask = presence(batch[first + WTS], batch[first + LEN])
        seq_parts, tar_parts = [], []
        for user, item in group:
            for feat, parts in ((user, seq_parts), (item, tar_parts)):
                s, ids = spec_of[feat], batch[feat + IDS]
                raw = look.take(s.table, emb[s.table], ids)
                cache[feat] = raw
                parts.append(torch.where((ids > 0)[..., None], raw,
                                         torch.zeros((), dtype=raw.dtype,
                                                     device=raw.device))
                             if conf.zero_pad else raw)
        seq = torch.cat(seq_parts, -1).float()
        tar = torch.cat([t[:, 0, :] for t in tar_parts], -1).float()
        if gi < len(conf.attention_ts):
            ts = conf.attention_ts[gi]
            s = spec_of[ts]
            cache[ts] = look.take(s.table, emb[s.table],
                                  ts_bucket(batch[ts + IDS], s.rows))
        states.append(interest(conf, params["trans"][f"seq{gi}"], seq, mask,
                               tar, train, gen))
    parts = [batch["features"]]
    ts_feats = set(conf.attention_ts)
    for s in conf.embeddings:
        ids = batch[s.feature + IDS]
        grid = cache.get(s.feature)
        if grid is None:
            grid = look.take(s.table, emb[s.table],
                             ts_bucket(ids, s.rows) if s.feature in ts_feats
                             else ids)
        parts.append(pool_mean(grid, batch[s.feature + WTS],
                               batch[s.feature + LEN]))
    x = torch.cat([torch.cat(parts, -1).float(), torch.cat(states, -1)], -1)

    # MMoE: experts as batched products, both gates in one product
    experts, E = params["mmoe"]["experts"], conf.num_experts
    w0 = torch.cat([e["layer0"]["dense"]["w"] for e in experts], 1)
    b0 = torch.cat([e["layer0"]["dense"]["b"] for e in experts])
    y = torch.relu(x @ w0 + b0).reshape(x.shape[0], E, -1)
    for i in range(1, len(conf.hidden_bottom)):
        wi = torch.stack([e[f"layer{i}"]["dense"]["w"] for e in experts])
        bi = torch.stack([e[f"layer{i}"]["dense"]["b"] for e in experts])
        y = torch.relu(torch.einsum("beh,ehk->bek", y, wi) + bi[None])
    gates = params["mmoe"]["gates"]
    gz = (x @ torch.cat([g["w"] for g in gates], 1)
          + torch.cat([g["b"] for g in gates])).reshape(x.shape[0], 2, E)
    ex = y.transpose(1, 2)
    logits = []
    for task, mix in zip(("click", "order"), torch.softmax(gz, -1).unbind(1)):
        h = torch.einsum("bhe,be->bh", ex, mix)
        tp = params[task]
        for i in range(len(conf.hidden_task)):
            h = torch.relu(_lin(tp[f"layer{i}"]["dense"], h))
        logits.append(_lin(tp["out"]["dense"], h).reshape(-1))
    if not with_bias:
        return tuple(logits), None

    # bias net: float32 tables whatever their size
    bn = params["bias_net"]
    bparts = [pool_mean(Lookups().take(s.table, bn["emb"][s.table],
                                       batch[s.feature + IDS]),
                        batch[s.feature + WTS], batch[s.feature + LEN])
              for s in conf.embeddings_bias]
    h = torch.cat(bparts, -1)
    for i in range(len(conf.hidden_bias)):
        h = torch.relu(_lin(bn["mlp"][f"layer{i}"]["dense"], h))
        if train and i < len(conf.dropout_rate_bias):
            h = _dropout(gen, h, conf.dropout_rate_bias[i])
    return tuple(logits), _lin(bn["mlp"]["out"]["dense"], h).reshape(-1)


def _xent(p, labels):
    pl = torch.where(labels > 0.5, p, 1.0 - p)
    return -torch.log(pl.clamp(KERAS_EPS, 1.0 - KERAS_EPS))


def loss(conf, logits, bias, mask):
    """The unbiased two-head loss: CE on sigmoid(rel + bias) (or the
    product), plus CE on sigmoid(rel) under ``ctr_rel``; per task
    ``sum_c mean_b mask * class_weight * CE``; tasks weighted."""
    click, order = logits
    sig = torch.sigmoid
    if conf.loss_unbias_method == "two_head_multiply":
        pc, po = sig(click) * sig(bias), sig(order) * sig(bias)
    else:
        pc, po = sig(click + bias), sig(order + bias)
    lc = mask[:, 1:5].sum(-1)
    lo = mask[:, 3] + mask[:, 4]
    xc, xo = _xent(pc, lc), _xent(po, lo)
    if conf.loss_ctr_rel_method == "ctr_rel":
        xc = xc + _xent(sig(click), lc)
        xo = xo + _xent(sig(order), lo)

    def reduce(x, pairs):
        w = torch.tensor([v for _, v in pairs], dtype=mask.dtype,
                         device=mask.device)
        return (mask * w[None, :] * x[:, None]).mean(0).sum()

    return (conf.loss_weight[0] * reduce(xc, conf.weight_ctr)
            + conf.loss_weight[1] * reduce(xo, conf.weight_ecvr))


def scores(conf, logits):
    """(Scores, click_Scores, order_Scores) from the relevance logits."""
    pc, po = torch.sigmoid(logits[0]), torch.sigmoid(logits[1])
    w0, w1 = conf.export_weight[0], conf.export_weight[1]
    return (w0 * pc + w1 * po) / float(w0 + w1), pc, po
