"""Analytical roofline cost model per (config x input shape x mesh).

The reference's cost model (``repro.analysis.costmodel``) with the
card's rates passed in explicitly as a :class:`~repro_torch.analysis.
roofline.Hardware` instead of read from module constants.  Every sum is
formed in the reference's order, so under equal constants the durations
come out equal to the last bit (the transfer timeline's simulated clock
adds them, and the parity tests compare its stalls exactly).

Conventions (everything PER DEVICE PER STEP):
  * matmul [m,k]@[k,n]: flops 2mkn; HBM traffic (2(mk + kn + mn)) bytes at
    bf16 — one read of each operand + one write (a first-order bound).
  * train = fwd + recompute + 2x bwd under full remat => 4x fwd flops;
    "dots"/none remat => 3x.
  * batch/sequence per device: tokens_local = B*S / (pods*dp); the model
    axis divides head/ffn dims (TP).
  * collectives: ring cost, link-bytes per device:
      all-gather/reduce-scatter: (p-1)/p * buffer
      all-reduce: 2(p-1)/p * buffer

Every family of the registry is priced: the dense family and
phi-3-vision's decoder (``vlm``, its projector in the parameter bytes),
MoE with GQA or MLA attention (``moe``), xLSTM (``ssm``: mLSTM and sLSTM
layers), the zamba2 hybrid (Mamba2 layers and the shared block) and
whisper's encoder-decoder (``audio``).  An arch type no config defines
raises ``KeyError`` (the reference prices only its stem).
"""

from __future__ import annotations

import dataclasses

from repro_torch.analysis.roofline import Hardware
from repro_torch.configs.base import BaseConfig, InputShape


FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "audio")


def _check_family(at: str) -> None:
    if at not in FAMILIES:
        raise KeyError(f"unknown arch_type {at!r}; the cost model prices "
                       f"{', '.join(FAMILIES)}")


@dataclasses.dataclass
class CostTerms:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    # link bytes by mesh axis role
    zero_bytes: float = 0.0  # chunk all-gather + grad reduce-scatter (data)
    tp_bytes: float = 0.0  # activation psums (model)
    pod_bytes: float = 0.0  # inter-pod grad psum (pod)

    def add_matmul(self, m, k, n, *, itemsize=2.0, count=1.0):
        self.flops += 2.0 * m * k * n * count
        self.hbm_bytes += itemsize * (m * k + k * n + m * n) * count

    @property
    def collective_bytes(self) -> float:
        return self.zero_bytes + self.tp_bytes + self.pod_bytes

    def seconds(self, hw: Hardware) -> dict:
        coll = (0.0 if hw.collective_bw is None
                else self.collective_bytes / hw.collective_bw)
        return {
            "compute_s": self.flops / hw.peak_flops,
            "memory_s": self.hbm_bytes / hw.hbm_bw,
            "collective_s": coll,
        }


def _ring(p: int) -> float:
    return (p - 1) / p if p > 1 else 0.0


def _attn_flops(ct: CostTerms, b, s, h, hd, *, causal=True, kv_len=None,
                train_mult=1.0):
    """Score + value matmuls of attention (per device; h is tp-local)."""
    kv = kv_len if kv_len is not None else s
    eff = 0.5 if (causal and kv_len is None) else 1.0
    flops = 2.0 * b * s * kv * h * hd * 2 * eff
    ct.flops += flops * train_mult
    # flash streaming: read K/V once per q block + q + out
    ct.hbm_bytes += 2.0 * b * kv * h * hd * 2 * train_mult  # K,V bf16
    ct.hbm_bytes += 2.0 * b * s * h * hd * 2 * train_mult  # Q, out


def analyze_pair(cfg: BaseConfig, shape: InputShape, *, dp: int, tp: int,
                 pods: int = 1, remat: str = "full",
                 gather_per_layer: bool = True,
                 ep_combine_first: bool = False,
                 zero_gathers_train: int | None = None) -> CostTerms:
    """Analytical per-device roofline terms for one (config, shape).
    ``ep_combine_first``: the MoE layer's expert-output psum moves the
    combined [T, d] instead of [E, C, d]; ``zero_gathers_train``: the
    ZeRO gathers a training step makes (default 2 under full remat, else
    1); ``gather_per_layer`` is the reference's, accepted and unread."""
    at = cfg.arch_type
    _check_family(at)
    ct = CostTerms()
    b_loc = max(shape.global_batch // (dp * pods), 1)
    kind = shape.kind
    s = shape.seq_len if kind != "decode" else 1
    kv_len = shape.seq_len if kind == "decode" else None
    t_loc = b_loc * s  # tokens per device
    d = cfg.d_model
    mult = (4.0 if remat == "full" else 3.0) if kind == "train" else 1.0

    # ---------------- per-layer ledger ------------------------------------
    def dense_attn_layer(c: BaseConfig):
        h_l = max(c.n_heads // tp, 1)
        kv_heads = c.n_kv_heads
        kv_l = max(kv_heads // tp, 1) if kv_heads % tp == 0 else kv_heads
        hd = c.head_dim
        ct.add_matmul(t_loc, d, h_l * hd, count=mult)  # wq
        ct.add_matmul(t_loc, d, kv_l * hd, count=2 * mult)  # wk, wv
        ct.add_matmul(t_loc, h_l * hd, d, count=mult)  # wo
        window = c.sliding_window
        akv = min(kv_len or s, window) if window else (kv_len or s)
        _attn_flops(ct, b_loc, s, h_l, hd, causal=True,
                    kv_len=akv if kind == "decode" else None, train_mult=mult)

    def mlp(c, width=None):
        f_l = max((width or c.d_ff) // tp, 1)
        n = 3 if c.gated_mlp else 2
        ct.add_matmul(t_loc, d, f_l, count=(n - 1) * mult)
        ct.add_matmul(t_loc, f_l, d, count=mult)

    def mla_layer(c):
        h_l = max(c.n_heads // tp, 1)
        nr = c.qk_nope_dim + c.qk_rope_dim
        r = c.kv_lora_rank
        ct.add_matmul(t_loc, d, h_l * nr, count=mult)  # wq
        # w_dkv and w_krope
        ct.add_matmul(t_loc, d, r + c.qk_rope_dim, count=mult)
        if kind == "decode":
            # absorbed: q -> latent, scores and out in the latent space
            # over the cache / tp
            c_loc = (kv_len or s) // tp
            ct.add_matmul(b_loc, h_l * c.qk_nope_dim, r, count=1)
            ct.flops += (2.0 * b_loc * c.n_heads * c_loc
                         * (r + c.qk_rope_dim) * 2)
            ct.hbm_bytes += b_loc * c_loc * (r + c.qk_rope_dim) * 2
            ct.add_matmul(b_loc, r, h_l * c.v_head_dim, count=1)
        else:
            ct.add_matmul(t_loc, r, h_l * c.qk_nope_dim, count=mult)  # w_uk
            ct.add_matmul(t_loc, r, h_l * c.v_head_dim, count=mult)  # w_uv
            _attn_flops(ct, b_loc, s, h_l, nr, train_mult=mult)
        ct.add_matmul(t_loc, h_l * c.v_head_dim, d, count=mult)  # wo

    def moe_layer(c):
        e = c.n_experts
        ct.add_matmul(t_loc, d, e, itemsize=4, count=mult)  # router fp32
        cap = max(int(t_loc * c.top_k * c.capacity_factor / e), 4)
        if c.moe_impl == "ep" and e % tp == 0:
            e_l, f_l = e // tp, c.d_ff_expert
        else:
            e_l, f_l = e, max(c.d_ff_expert // tp, 1)
        ct.add_matmul(e_l * cap, d, f_l, count=2 * mult)  # gate, up
        ct.add_matmul(e_l * cap, f_l, d, count=mult)  # down
        if c.n_shared_experts:
            mlp(c, width=c.d_ff_expert * c.n_shared_experts)
        # the expert outputs' psum over model ([E, C, d] fp32, or [T, d]
        # when the combine runs before the psum)
        buf = (t_loc * d * 4.0 if ep_combine_first else e * cap * d * 4.0)
        ct.tp_bytes += 2.0 * _ring(tp) * buf * (mult if kind == "train"
                                                 else 1)

    def mamba_layer(c):
        di_l = max(c.d_inner // tp, 1)
        nh_l = max(c.mamba_heads // tp, 1)
        ds = c.ssm_state
        ct.add_matmul(t_loc, d, 2 * di_l + 2 * ds + nh_l, count=mult)
        ct.add_matmul(t_loc, di_l, d, count=mult)  # out proj
        # SSD: intra-chunk quadratic (q=chunk_len) + state updates
        q = c.chunk_len
        eff_s = s if kind != "decode" else 1
        ct.flops += (2.0 * b_loc * eff_s * q * nh_l * (c.mamba_headdim + ds)
                     + 4.0 * b_loc * eff_s * nh_l * c.mamba_headdim * ds
                     ) * mult
        if kind == "decode":
            ct.hbm_bytes += b_loc * nh_l * c.mamba_headdim * ds * 4  # state

    def mlstm_layer(c):
        di = c.d_inner
        nh = c.n_heads
        dh = di // nh
        dv = dh // tp if dh % tp == 0 and tp > 1 else dh
        ct.add_matmul(t_loc, d, di, count=mult)  # up
        ct.add_matmul(t_loc, di, 2 * nh * dh + nh * dv + 2 * nh, count=mult)
        ct.add_matmul(t_loc, nh * dv, d, count=mult)  # down
        q = c.chunk_len
        eff_s = s if kind != "decode" else 1
        ct.flops += (2.0 * b_loc * eff_s * q * nh * (dh + dv)
                     + 4.0 * b_loc * eff_s * nh * dh * dv) * mult
        if kind == "decode":
            ct.hbm_bytes += b_loc * nh * dh * dv * 4

    def slstm_layer(c):
        di = c.d_inner
        nh = c.n_heads
        dh = di // nh
        ct.add_matmul(t_loc, d, 4 * di, count=mult)
        ct.flops += 2.0 * b_loc * s * nh * dh * 4 * dh * mult  # recurrent R
        ct.add_matmul(t_loc, di, d, count=mult)
        ff = int(d * 4 / 3) // 8 * 8
        ct.add_matmul(t_loc, d, ff, count=mult)
        ct.add_matmul(t_loc, ff, d, count=mult)

    if at in ("dense", "vlm"):
        # vlm: the decoder over the sequence the shape names (the
        # reference's ledger prices no projector)
        for _ in range(cfg.num_layers):
            dense_attn_layer(cfg)
            mlp(cfg)
        layers_psums = 2 * cfg.num_layers
    elif at == "moe":
        for _ in range(cfg.first_dense_layers):
            dense_attn_layer(cfg)
            mlp(cfg)
        for _ in range(cfg.num_layers - cfg.first_dense_layers):
            if cfg.use_mla:
                mla_layer(cfg)
            else:
                dense_attn_layer(cfg)
            moe_layer(cfg)
        layers_psums = 2 * cfg.num_layers
    elif at == "ssm":  # xlstm
        n_m = cfg.num_units * cfg.mlstm_per_unit
        n_s = cfg.num_units * cfg.slstm_per_unit
        for _ in range(n_m):
            mlstm_layer(cfg)
        for _ in range(n_s):
            slstm_layer(cfg)
        layers_psums = n_m
    elif at == "hybrid":  # zamba2
        for _ in range(cfg.num_layers):
            mamba_layer(cfg)
        # shared attention block at 2d width, once per unit
        sc = cfg.replace(d_model=2 * d, sliding_window=None)
        d2 = 2 * d
        for _ in range(cfg.num_units):
            h_l = max(sc.n_heads // tp, 1)
            ct.add_matmul(t_loc, d2, 4 * h_l * sc.head_dim, count=mult)
            _attn_flops(ct, b_loc, s, h_l, sc.head_dim,
                        kv_len=kv_len, train_mult=mult)
            f_l = max(sc.d_ff // tp, 1)
            ct.add_matmul(t_loc, d2, f_l, count=2 * mult)
            ct.add_matmul(t_loc, f_l, d2, count=mult)
            ct.add_matmul(t_loc, d2, d, count=mult)  # w_proj
        layers_psums = cfg.num_layers + 2 * cfg.num_units
    else:  # audio: whisper, the encoder over its frames + the decoder
        enc_t = b_loc * min(cfg.encoder_frames, shape.seq_len)
        h, hd = cfg.n_heads, cfg.head_dim  # attention replicated (20 % 16)
        for _ in range(cfg.num_encoder_layers):
            if kind != "decode":
                ct.add_matmul(enc_t, d, 4 * h * hd, count=mult)
                _attn_flops(ct, b_loc, min(cfg.encoder_frames,
                                           shape.seq_len),
                            h, hd, causal=False, train_mult=mult)
                ct.add_matmul(enc_t, d, cfg.d_ff // tp, count=mult)
                ct.add_matmul(enc_t, cfg.d_ff // tp, d, count=mult)
        for _ in range(cfg.num_layers):
            ct.add_matmul(t_loc, d, 4 * h * hd, count=mult)
            _attn_flops(ct, b_loc, s, h, hd, kv_len=kv_len, train_mult=mult)
            # cross attention over encoder frames
            _attn_flops(ct, b_loc, s, h, hd, causal=False,
                        kv_len=cfg.encoder_frames, train_mult=mult)
            ct.add_matmul(t_loc, d, cfg.d_ff // tp, count=mult)
            ct.add_matmul(t_loc, cfg.d_ff // tp, d, count=mult)
        layers_psums = cfg.num_layers + cfg.num_encoder_layers

    # ---------------- stem: embedding + head + xent ------------------------
    v_l = -(-cfg.vocab_size // tp)
    ct.hbm_bytes += t_loc * d * 2 * 2  # embed gather read+write
    if kind == "train":
        ct.add_matmul(t_loc, d, v_l, itemsize=2, count=3.0)  # head fwd+bwd
        ct.hbm_bytes += t_loc * v_l * 4 * 2  # fp32 logits + softmax pass
    else:
        ct.add_matmul(b_loc, d, v_l, count=1.0)

    # ---------------- collectives ------------------------------------------
    # ZeRO chunk traffic over `data`: params gathered per layer (or per
    # step), re-gathered in BWD under full remat, grads reduce-scattered.
    n_params_local = _param_bytes_local(cfg, tp)  # bf16 bytes per model-rank
    if kind == "train":
        gathers = zero_gathers_train if zero_gathers_train is not None \
            else (2 if remat == "full" else 1)
        ct.zero_bytes += (gathers + 1) * _ring(dp) * n_params_local
        if pods > 1:  # inter-pod grad psum (bf16 grads of the local shard)
            ct.pod_bytes += 2 * _ring(pods) * n_params_local / max(dp, 1)
    else:
        ct.zero_bytes += _ring(dp) * n_params_local
    # TP activation psums ([B_loc, s, d] bf16): fwd (+bwd, +re-fwd in train)
    psum_phases = (3.0 if remat == "full" else 2.0) if kind == "train" else 1.0
    ct.tp_bytes += (layers_psums * psum_phases
                    * 2.0 * _ring(tp) * t_loc * d * 2)
    # vocab-parallel xent psums (scalars per token, fp32, ~3 of them)
    ct.tp_bytes += 3 * 2.0 * _ring(tp) * t_loc * 4
    return ct


# ---------------------------------------------------------------------------
# Per-operator compute durations for the transfer timeline
# (core/timeline.py): the eager engines advance a simulated clock
# moment-by-moment; each operator's duration is its roofline time —
# max(flops/peak, hbm/bandwidth) — carved out of the analytical ledger.
# ---------------------------------------------------------------------------


def _roofline_seconds(ct: CostTerms, hw: Hardware) -> float:
    return max(ct.flops / hw.peak_flops, ct.hbm_bytes / hw.hbm_bw)


@dataclasses.dataclass(frozen=True)
class TrainOperatorCosts:
    """Durations of the training engine's moment kinds (seconds)."""

    fwd_layer_s: float
    bwd_layer_s: float  # recompute + grad under full remat: 3x fwd
    adam_chunk_s: float  # one chunk's 4-stream quad update

    def of_moment(self, op_name: str, phase: str) -> float:
        """Duration of one tracer moment.  ``.end`` moments mark the
        operator's finish and carry no compute of their own."""
        if op_name.endswith(".end"):
            return 0.0
        if phase == "FWD":
            return self.fwd_layer_s
        if phase == "BWD":
            return self.bwd_layer_s
        if phase == "ADAM":
            return self.adam_chunk_s
        return 0.0


def train_operator_costs(
    cfg: BaseConfig,
    *,
    hw: Hardware,
    global_batch: int,
    seq_len: int,
    num_layer_ops: int,
    chunk_bytes: int,
    dp: int = 1,
) -> TrainOperatorCosts:
    """Per-operator durations of one training iteration on ``hw``.

    The analytical train ledger is 4x forward under full remat
    (fwd + recompute + 2x bwd), so one layer's forward is a quarter of
    the step divided over the layer count, and a backward_layer moment
    (recompute + both grads) is the remaining 3x.  The ADAM chunk update
    is memory-bound: read+write of the grad/p32/m/v quad at HBM
    bandwidth."""
    shape = InputShape("timeline", seq_len, max(global_batch, 1), "train")
    ct = analyze_pair(cfg, shape, dp=dp, tp=1, remat="full")
    fwd_layer = _roofline_seconds(ct, hw) / 4.0 / max(num_layer_ops, 1)
    return TrainOperatorCosts(
        fwd_layer_s=fwd_layer,
        bwd_layer_s=3.0 * fwd_layer,
        adam_chunk_s=2.0 * 4.0 * chunk_bytes / hw.hbm_bw,
    )


@dataclasses.dataclass(frozen=True)
class ServeOperatorCosts:
    """Durations of the serving engine's per-layer ops (seconds)."""

    prefill_layer_s: float  # one layer over one prompt
    decode_layer_s: float  # one layer, one token, one sequence


def serve_operator_costs(
    cfg: BaseConfig, *, hw: Hardware, prompt_tokens: int, horizon: int,
    num_layers: int
) -> ServeOperatorCosts:
    """Per-layer prefill/decode durations for one sequence (batch 1)."""
    n = max(num_layers, 1)
    pre = analyze_pair(
        cfg, InputShape("timeline", max(prompt_tokens, 1), 1, "prefill"),
        dp=1, tp=1)
    dec = analyze_pair(
        cfg, InputShape("timeline", max(horizon, 1), 1, "decode"), dp=1, tp=1)
    return ServeOperatorCosts(
        prefill_layer_s=_roofline_seconds(pre, hw) / n,
        decode_layer_s=_roofline_seconds(dec, hw) / n,
    )


def _param_bytes_local(cfg: BaseConfig, tp: int) -> float:
    """bf16 parameter bytes per model-rank (what ZeRO gathers move)."""
    at = cfg.arch_type
    _check_family(at)
    d = cfg.d_model
    v_l = -(-cfg.vocab_size // tp)
    h_l = max(cfg.n_heads // tp, 1)
    kv_l = (max(cfg.n_kv_heads // tp, 1) if cfg.n_kv_heads % tp == 0
            else cfg.n_kv_heads)
    hd = cfg.head_dim
    total = v_l * d  # embedding
    if not cfg.tie_embeddings:
        total += v_l * d

    def dense_layer(c):
        n = d * (h_l * hd + 2 * kv_l * hd) + h_l * hd * d
        return n + d * max(c.d_ff // tp, 1) * (3 if c.gated_mlp else 2)

    if at in ("dense", "vlm"):
        total += cfg.num_layers * dense_layer(cfg)
        if at == "vlm":  # the projector
            total += cfg.vision_dim * d + d * d
    elif at == "moe":
        nr = cfg.qk_nope_dim + cfg.qk_rope_dim
        r = cfg.kv_lora_rank
        if cfg.use_mla:
            attn = (d * (h_l * nr) + d * (r + cfg.qk_rope_dim)
                    + r * h_l * (cfg.qk_nope_dim + cfg.v_head_dim)
                    + h_l * cfg.v_head_dim * d)
        else:
            attn = d * (h_l * hd + 2 * kv_l * hd) + h_l * hd * d
        e = cfg.n_experts
        if cfg.moe_impl == "ep" and e % tp == 0:
            ex = (e // tp) * 3 * d * cfg.d_ff_expert
        else:
            ex = e * 3 * d * max(cfg.d_ff_expert // tp, 1)
        if cfg.n_shared_experts:
            ex += 3 * d * max(cfg.d_ff_expert * cfg.n_shared_experts // tp,
                              1)
        moe_layers = cfg.num_layers - cfg.first_dense_layers
        total += moe_layers * (attn + ex + d * e)
        total += cfg.first_dense_layers * dense_layer(cfg)
    elif at == "ssm":
        di = cfg.d_inner
        nh = cfg.n_heads
        dh = di // nh
        dv = dh // tp if dh % tp == 0 and tp > 1 else dh
        m = (d * di + di * (2 * nh * dh + nh * dv + 2 * nh) + nh * dv * d
             + d * nh * dv)
        sl = (d * 4 * di + nh * dh * 4 * dh + di * d
              + 2 * d * (int(d * 4 / 3) // 8 * 8))
        total += cfg.num_units * (cfg.mlstm_per_unit * m
                                  + cfg.slstm_per_unit * sl)
    elif at == "hybrid":
        di_l = max(cfg.d_inner // tp, 1)
        nh_l = max(cfg.mamba_heads // tp, 1)
        m = (d * (2 * di_l + 2 * cfg.ssm_state + nh_l) + di_l * d)
        total += cfg.num_layers * m
        d2 = 2 * d
        sc_f = max(cfg.d_ff // tp, 1)
        total += (d2 * 4 * h_l * hd + d2 * sc_f * 3 + cfg.num_units * d2 * d)
    else:  # audio
        lay = d * 4 * cfg.n_heads * hd + d * (cfg.d_ff // tp) * 2
        total += cfg.num_encoder_layers * lay
        total += cfg.num_layers * (lay + d * 4 * cfg.n_heads * hd)
        total += cfg.frontend_dim * d + cfg.encoder_frames * d
    return float(total) * 2.0  # bf16
