"""The model in plain PyTorch: encoder, MBV units, decoder, speaker
classifier and patch critic as functions of a parameter dict.

A frozen copy of the port's model code (``models/*.py`` of
zerospeech_tts_tpu_torch) with its GRU kernels replaced by their plain
recurrence, so that it imports nothing of the port. Parameter names and
layouts are the port's state-dict names (``bank.bank_1.Conv_0.weight``,
``rnn.fwd.wh``, ...). Tensors are [B, T, C] as in the port. ``q`` rounds
the operands of every product and convolution (reference/precision.py);
``noise`` draws uniforms (training dropout, Gumbel noise), None in
inference. A module runs in the dtype of its parameters: float32, or
bfloat16 with the GRU's state and gates in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.precision import exact

MODULES = ("enc", "dec", "clf", "dis")
DIS_CHANNELS = (32, 64, 128, 256)


def n_down(hp: dict) -> int:
    return int(hp["downsample"]).bit_length() - 1


def param_shapes(hp: dict, module: str) -> dict[str, tuple[int, ...]]:
    """name -> shape of every parameter of ``module`` (the port's state dict)."""
    out: dict[str, tuple[int, ...]] = {}

    def conv(name, cout, cin, k):
        out[f"{name}.Conv_0.weight"] = (cout, cin, k)
        out[f"{name}.Conv_0.bias"] = (cout,)

    def dense(name, fout, fin):
        out[f"{name}.weight"] = (fout, fin)
        out[f"{name}.bias"] = (fout,)

    def gru(name, fin, h):
        out[f"{name}.wh"] = (h, 3 * h)
        out[f"{name}.bh"] = (3 * h,)
        dense(f"{name}.wi", 3 * h, fin)

    c, emb, e = hp["conv_channels"], hp["emb_size"], hp["spk_emb_size"]
    if module == "enc":
        for k in range(1, hp["bank_size"] + 1):
            conv(f"bank.bank_{k}", hp["bank_channels"], hp["n_feat"], k)
        conv("proj", c, hp["bank_size"] * hp["bank_channels"] + hp["n_feat"], 3)
        for i in range(n_down(hp)):
            conv(f"down_{i}", c, c, 3)
            conv(f"res_{i}", c, c, 3)
        dense("dense", emb, c)
        gru("rnn.fwd", emb, emb // 2)
        gru("rnn.bwd", emb, emb // 2)
        dense("head", 2 * emb, emb)
    elif module == "dec":
        out["spk_embed.embedding"] = (hp["n_speakers"], e)
        conv("proj", c, emb + e, 3)
        for i in range(n_down(hp)):
            conv(f"up_{i}", 2 * c, c + e, 3)
            conv(f"res_{i}", c, c, 3)
        gru("rnn", c + e, c)
        dense("out", hp["n_feat"], c)
    elif module == "clf":
        chans = [emb, c, c, c // 2]
        for i in range(3):
            conv(f"conv_{i}", chans[i + 1], chans[i], 3)
        dense("dense", c // 2, c // 2)
        dense("out", hp["n_speakers"], c // 2)
    elif module == "dis":
        cin = 1
        for i, ch in enumerate(DIS_CHANNELS):
            out[f"conv_{i}.weight"] = (ch, cin, 5, 5)
            out[f"conv_{i}.bias"] = (ch,)
            cin = ch
        out["patch_head.weight"] = (1, cin, 3, 3)
        out["patch_head.bias"] = (1,)
        dense("cls_head", hp["n_speakers"], cin)
    else:
        raise ValueError(f"unknown module {module!r}")
    return out


# ---------------------------------------------------------------- layers


def dropout(x, rate: float, noise):
    """Keep each element with probability 1 - rate (uniform < 1 - rate),
    kept ones scaled by 1 / (1 - rate); the identity without noise."""
    if noise is None or rate == 0.0:
        return x
    keep = noise.uniform(x.shape, x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), device=x.device))


def linear(p, name, x, q=exact):
    return F.linear(q(x), q(p[f"{name}.weight"]), p[f"{name}.bias"])


def conv1d(p, name, x, k: int, ns: float, stride: int = 1, q=exact):
    """Reflect-padded 1-D convolution + leaky ReLU over [B, T, C] (the
    extra tap of an even kernel on the right)."""
    lpad = (k - 1) // 2
    rpad = k - 1 - lpad
    xt = x.transpose(1, 2)
    if lpad or rpad:
        xt = F.pad(xt, (lpad, rpad), mode="reflect")
    y = F.conv1d(q(xt), q(p[f"{name}.Conv_0.weight"]), p[f"{name}.Conv_0.bias"], stride=stride)
    return F.leaky_relu(y.transpose(1, 2), ns)


def gru(p, name, x, reverse: bool = False, q=exact):
    """GRU over time, input projection for all steps at once, then the plain
    recurrence (gate order r, z, n): hw = h wh + bh; r = sig(xr + hw_r);
    z = sig(xz + hw_z); n = tanh(xn + r hw_n); h' = (1 - z) n + z h. The
    state and the gates are float32 under a bfloat16 module, each step's
    product taking h rounded to bfloat16, and the outputs store h in the
    module's dtype."""
    xw = linear(p, f"{name}.wi", x, q)
    wh, bh = p[f"{name}.wh"], p[f"{name}.bh"]
    ct = torch.float32 if xw.dtype == torch.bfloat16 else xw.dtype
    b, t, h3 = xw.shape
    h = h3 // 3
    wh_c, bh_c = q(wh).to(ct), bh.to(ct)
    hcur = xw.new_zeros(b, h, dtype=ct)
    outs = [None] * t
    for ti in range(t - 1, -1, -1) if reverse else range(t):
        hw = q(hcur.to(wh.dtype)).to(ct) @ wh_c + bh_c
        xr, xz, xn = xw[:, ti].to(ct).split(h, dim=-1)
        hr, hz, hn = hw.split(h, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        hcur = (1.0 - z) * n + z * hcur
        outs[ti] = hcur
    return torch.stack(outs, dim=1).to(xw.dtype)


def append_emb(x, emb):
    b, t, _ = x.shape
    return torch.cat([x, emb[:, None, :].expand(b, t, emb.shape[-1])], dim=-1)


# ---------------------------------------------------------------- modules


def encoder(p, hp: dict, x, q=exact, noise=None):
    """Features [B, T, n_feat] -> logits [B, ceil(T / downsample), emb, 2]:
    conv bank 1..bank_size, projection, stride-2 residual stages (dropout
    after each with ``noise``), dense, bidirectional GRU, 2-logit head."""
    ns = hp["ns"]
    x = x.to(p["head.weight"].dtype)
    bank = [conv1d(p, f"bank.bank_{k}", x, k, ns, q=q) for k in range(1, hp["bank_size"] + 1)]
    y = conv1d(p, "proj", torch.cat(bank + [x], dim=-1), 3, ns, q=q)
    for i in range(n_down(hp)):
        z = conv1d(p, f"down_{i}", y, 3, ns, stride=2, q=q)
        z = conv1d(p, f"res_{i}", z, 3, ns, q=q)
        y = dropout(z + y[:, ::2, :], hp["enc_dp"], noise)
    y = F.leaky_relu(linear(p, "dense", y, q), ns)
    y = torch.cat([gru(p, "rnn.fwd", y, False, q), gru(p, "rnn.bwd", y, True, q)], dim=-1)
    logits = linear(p, "head", y, q)
    b, t, _ = logits.shape
    return logits.reshape(b, t, hp["emb_size"], 2)


def units(logits):
    """MBV unit bits: on > off, as int32."""
    return (logits[..., 0] > logits[..., 1]).to(torch.int32)


def gumbel_binary(logits, temperature: float, noise):
    """Straight-through two-way Gumbel-softmax over {on, off}: the hard
    one-hot forward, the soft gradient; the "on" coordinate."""
    u = noise.uniform(logits.shape, logits.device).clamp_min(1e-20)
    soft = torch.softmax((logits - torch.log(-torch.log(u))) / temperature, dim=-1)
    hard = F.one_hot(soft.argmax(dim=-1), soft.shape[-1]).to(soft.dtype)
    return (soft + (hard - soft).detach())[..., 0]


def decoder(p, hp: dict, z, spk, q=exact):
    """Latent [B, T', emb] + speaker ids [B] -> features [B, T' x
    downsample, n_feat]: the speaker embedding at every block, a
    sub-pixel x2 upsample a stage, GRU, dense."""
    ns = hp["ns"]
    z = z.to(p["out.weight"].dtype)
    emb = p["spk_embed.embedding"][spk]
    y = conv1d(p, "proj", append_emb(z, emb), 3, ns, q=q)
    for i in range(n_down(hp)):
        y = conv1d(p, f"up_{i}", append_emb(y, emb), 3, ns, q=q)
        b, t, c2 = y.shape
        y = y.reshape(b, t, 2, c2 // 2).reshape(b, 2 * t, c2 // 2)
        y = y + conv1d(p, f"res_{i}", y, 3, ns, q=q)
    y = gru(p, "rnn", append_emb(y, emb), False, q)
    return linear(p, "out", y, q)


def _same_pad(n: int, k: int, s: int) -> tuple[int, int]:
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv2d_same(p, name, y, stride: int, q):
    w = p[f"{name}.weight"]
    t_lo, t_hi = _same_pad(y.shape[2], w.shape[2], stride)
    f_lo, f_hi = _same_pad(y.shape[3], w.shape[3], stride)
    return F.conv2d(q(F.pad(y, (f_lo, f_hi, t_lo, t_hi))), q(w), p[f"{name}.bias"], stride=stride)


def critic(p, hp: dict, x, q=exact, noise=None):
    """Features [B, T, n_feat] as a one-channel image -> (patch validity
    [B, t', f'], speaker logits [B, n_speakers]): four 5x5 stride-2
    convolutions with "SAME" padding (the smaller half first), leaky ReLU
    and dropout, a 3x3 patch head, a speaker head on the spatial mean."""
    y = x[:, None]
    for i in range(len(DIS_CHANNELS)):
        y = F.leaky_relu(_conv2d_same(p, f"conv_{i}", y, 2, q), hp["ns"])
        y = dropout(y, hp["dis_dp"], noise)
    patch = _conv2d_same(p, "patch_head", y, 1, q)[:, 0]
    return patch, linear(p, "cls_head", y.mean(dim=(2, 3)), q)
