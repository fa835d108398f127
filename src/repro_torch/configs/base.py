"""Config dataclasses of the port: the architectures' ``ModelConfig``, the
paper's framework knobs, the DP defense and the wire's network model,
copied from the reference's configs/base.py with the same fields,
defaults, validation and ``enabled``/``resolved`` semantics.
``ModelConfig`` keeps the fields every family of the registry reads
(dense, moe, ssm, hybrid, vlm, audio), their serving cache and ``remat``
(per-layer activation checkpointing when a loss is differentiated); the
scan over layers has no counterpart here. ``TrainConfig`` holds the
first-order trainer's knobs. ``RuntimeConfig``
holds the TCP federation runtime's knobs. ``dp/accountant.py``
calibrates ``DPConfig.noise_multiplier`` from a target epsilon.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01  # load-balance auxiliary loss

    @property
    def held(self) -> Tuple[int, int]:
        """(first, count): the experts this layer holds, all of them."""
        return 0, self.num_experts


@dataclass(frozen=True)
class MoEShard(MoEConfig):
    """A card's share of an expert-parallel layer: it routes over all
    ``num_experts`` and holds experts [first, first + count) of them
    (``sharding.rules.expert_shard`` makes one). A subclass, so the
    architectures' ``MoEConfig`` keeps the reference's fields."""
    first: int = 0
    count: int = 0

    def __post_init__(self):
        if not (0 <= self.first and 0 < self.count
                and self.first + self.count <= self.num_experts):
            raise ValueError(f"experts [{self.first}, "
                             f"{self.first + self.count}) are not a share "
                             f"of {self.num_experts}")

    @property
    def held(self) -> Tuple[int, int]:
        return self.first, self.count


@dataclass(frozen=True)
class SSMConfig:
    kind: str = "rwkv6"          # 'rwkv6' | 'mamba2'
    state_size: int = 16          # N for mamba-style; head_size for rwkv
    expand: int = 2               # d_inner = expand * d_model (mamba)
    chunk_size: int = 128         # chunked-scan block length
    decay_lora_rank: int = 64     # rwkv6 data-dependent decay LoRA rank


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int                # 0 for attention-free archs
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // num_heads
    qkv_bias: bool = False
    qk_norm: bool = False         # chameleon-style stabilization
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    pos_emb: str = "rope"         # rope | sinusoidal | none
    norm_eps: float = 1e-5
    sliding_window: Optional[int] = None   # None = full attention
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # --- enc-dec (whisper) ---
    enc_dec: bool = False
    num_encoder_layers: int = 0
    encoder_frames: int = 1500    # precomputed conv-frontend frames (stub
    #                               input)
    # --- modality frontend stub ---
    frontend: str = "none"        # none | audio_stub | vq_stub
    dtype: str = "bfloat16"
    remat: bool = True            # recompute each layer's activations in
    #                               the backward (torch.utils.checkpoint)
    chunked_ce: bool = False      # vocab-chunked loss: the (B, S, V)
    #                               logits never exist
    kv_cache_dtype: str = "model"  # "model" (= activation dtype) | "int8"
    #                               (quantized serving cache, per-position/
    #                               head scales: half the decode cache bytes)
    citation: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.num_heads == 0:
            return 0
        return self.d_model // self.num_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: <=2 layers, d_model<=256, <=4 experts, f32
        (the reference's rule, field for field)."""
        d_model = min(self.d_model, 256)
        n_heads = 0 if self.num_heads == 0 else min(self.num_heads, 4)
        ratio = max(1, (self.num_heads or 1) // max(1, self.num_kv_heads or 1))
        kv = 0 if n_heads == 0 else max(1, n_heads // min(ratio, n_heads))
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(self.moe, num_experts=4,
                                      top_k=min(self.moe.top_k, 2),
                                      d_ff_expert=128)
        ssm = None
        if self.ssm is not None:
            ssm = dataclasses.replace(self.ssm, chunk_size=16,
                                      decay_lora_rank=8)
        return dataclasses.replace(
            self, num_layers=2, d_model=d_model, num_heads=n_heads,
            num_kv_heads=kv, head_dim=64 if n_heads else 0,
            d_ff=min(self.d_ff, 512), vocab_size=min(self.vocab_size, 512),
            moe=moe, ssm=ssm,
            num_encoder_layers=min(self.num_encoder_layers, 2),
            encoder_frames=min(self.encoder_frames, 32),
            sliding_window=(min(self.sliding_window, 64)
                            if self.sliding_window else None),
            dtype="float32", remat=False)

    def num_params(self) -> int:
        """Parameter count: the embedding, the head, the final norm, every
        layer's leaves and, where the family has them, the encoder and
        the modality embedding, as ``Model.init`` makes them (the
        reference's count leaves out the norms and the q/k gammas, and
        takes whisper's encoder MLP as two matrices)."""
        d, L = self.d_model, self.num_layers
        p = self.vocab_size * d * (1 if self.tie_embeddings else 2) + d
        p += L * self._layer_params()
        if self.enc_dec:
            enc = self.replace(enc_dec=False, sliding_window=None)
            p += self.num_encoder_layers * enc._layer_params() + d
        if self.frontend == "vq_stub":
            p += 2 * d                                      # modality_embed
        return int(p)

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        H, KV = self.num_heads, self.num_kv_heads
        p = d * H * hd + 2 * d * KV * hd + H * hd * d
        if self.qkv_bias:
            p += (H + 2 * KV) * hd
        if self.qk_norm:
            p += 2 * hd                                     # q/k gammas
        return p

    def _layer_params(self) -> int:
        """One layer's leaves: the two norms and the family's blocks."""
        d, f = self.d_model, self.d_ff
        per_layer = 2 * d                                   # the two norms
        if self.family == "ssm":
            r = self.ssm.decay_lora_rank
            # time mix: 5 lerps, w0, u (H x K = d), ln_gamma; the decay
            # LoRA; r, k, v, g, o. Channel mix: 2 lerps, k, v, r
            per_layer += 8 * d + 2 * d * r + 5 * d * d
            per_layer += 2 * d + 2 * d * f + d * d
            return per_layer
        per_layer += self._attn_params()
        if self.moe is not None:
            E, fe = self.moe.num_experts, self.moe.d_ff_expert
            held = self.moe.held[1]
            per_layer += d * E + 3 * held * d * fe          # router, experts
        else:
            per_layer += 3 * d * f                          # swiglu
        if self.enc_dec:
            per_layer += self._attn_params() + d            # cross, norm3
        if self.family == "hybrid":
            di, N = self.ssm.expand * d, self.ssm.state_size
            nh = di // 64                                   # mamba heads
            # in_proj, conv (4 taps), bc_proj, dt_proj, dt_bias, A_log, D,
            # out_proj
            per_layer += d * 2 * di + 4 * di + d * 2 * N + d * nh \
                + 3 * nh + di * d
        return per_layer


@dataclass(frozen=True)
class DPConfig:
    """Differential privacy at the codec seam (dp/mechanisms.py).

    The defended release is every party->server payload (the c function
    values): each per-sample entry is clipped to ``[-clip, clip]`` and
    perturbed with mechanism noise of scale ``noise_multiplier * clip``
    BEFORE the up-link codec runs — DPZV-style, at the single
    ``ZOExchange.encode_up`` seam every executor shares.

    ``epsilon`` is the per-party (eps, delta)-DP target over a whole run
    (parallel composition across parties: feature blocks are disjoint,
    so each party's guarantee depends only on its OWN releases);
    ``epsilon=inf`` turns the subsystem transparently off (no clip, no
    noise — bit-identical to ``dp=None``). ``noise_multiplier`` is the
    resolved noise scale in clip units; leave it ``None`` and let
    ``repro_torch.dp.accountant.resolve_dp(dp, rounds=...)`` calibrate it
    from the target epsilon once the round budget is known. The exchange
    refuses to run with an uncalibrated epsilon target.
    """
    epsilon: Optional[float] = None     # flag: --dp-epsilon — target eps
    #                                     over the run (inf = off)
    delta: float = 1e-5                 # flag: --dp-delta
    clip: Optional[float] = None        # flag: --dp-clip — REQUIRED when
    #                                     enabled: |c_i| <= clip
    mechanism: str = "gaussian"         # internal-only: gaussian (RDP) |
    #                                     laplace (pure-DP); library/bench
    #                                     knob, the CLI defense is gaussian
    noise_multiplier: Optional[float] = None   # internal-only: sigma (noise
    #                                     std = sigma*clip) — resolved by the
    #                                     accountant
    sample_rate: Optional[float] = None  # internal-only: Poisson-subsampling
    #                                      rate q of the minibatch draw;
    #                                      opt-in: None means account WITHOUT
    #                                      amplification (the pre-existing,
    #                                      conservative curve)

    def __post_init__(self):
        if self.mechanism not in ("gaussian", "laplace"):
            raise ValueError(
                f"unknown DP mechanism {self.mechanism!r}; "
                f"have gaussian, laplace")
        if self.sample_rate is not None:
            if not 0.0 < self.sample_rate <= 1.0:
                raise ValueError(
                    f"sample_rate must be in (0, 1], got {self.sample_rate}")
            if self.mechanism != "gaussian":
                raise ValueError(
                    "subsampled amplification is only implemented for the "
                    "gaussian mechanism (MTZ19-style RDP bound); drop "
                    "sample_rate or use mechanism='gaussian'")
        if self.epsilon is not None and self.epsilon <= 0:
            raise ValueError(f"epsilon must be > 0, got {self.epsilon}")
        if not 0.0 < self.delta < 1.0:
            raise ValueError(f"delta must be in (0, 1), got {self.delta}")
        if self.noise_multiplier is not None and self.noise_multiplier < 0:
            raise ValueError("noise_multiplier must be >= 0")
        import math
        if (self.noise_multiplier == 0.0 and self.epsilon is not None
                and math.isfinite(self.epsilon)):
            raise ValueError(
                "noise_multiplier=0 (clip-only) cannot meet a finite "
                "epsilon target — drop the epsilon or supply real noise")
        if self.enabled and self.clip is None:
            raise ValueError(
                "DP epsilon/noise without a clip bound is incoherent: the "
                "mechanism's sensitivity IS the clip — set DPConfig.clip")
        if self.clip is not None and self.clip <= 0:
            raise ValueError(f"clip must be > 0, got {self.clip}")

    @property
    def enabled(self) -> bool:
        """Whether any defense actually applies (eps=inf means OFF)."""
        import math
        if self.noise_multiplier is not None:
            return True
        return self.epsilon is not None and math.isfinite(self.epsilon)

    @property
    def resolved(self) -> bool:
        """Whether the noise scale is known (ready to run)."""
        return not self.enabled or self.noise_multiplier is not None


@dataclass(frozen=True)
class VFLConfig:
    """The paper's framework knobs (Section 3)."""
    num_parties: int = 8          # flag: --parties — q
    party_hidden: int = 128       # internal-only: width of the party tower
    #                               F_m (--arch sizes the models)
    party_layers: int = 2         # internal-only: depth of F_m (paper:
    #                               2-layer FCN; sized by --arch)
    direction: str = "gaussian"   # internal-only: gaussian (AsyREVEL-Gau) |
    #                               uniform (-Uni) | rademacher (fused-kernel
    #                               seed replay); library/bench knob
    mu: float = 1e-3              # smoothing parameter mu_m (--mu)
    lr_party: float = 1e-3        # flag: --lr — eta_m
    lr_server: float = 1e-3 / 8   # flag: --lr — eta_0 = eta / q (paper
    #                               setting, derived from the same flag)
    max_delay: int = 4            # internal-only: tau (Assumption 4) for
    #                               the thread executor; the TCP runtime's
    #                               bound is RuntimeConfig.max_staleness
    activation_probs: Optional[Tuple[float, ...]] = None  # internal-only:
    #                               p_m (Assumption 3); bench schedule knob
    seed_replay: bool = False     # internal-only: MeZO-style u regeneration
    #                               (beyond-paper); implied by --fused
    num_directions: int = 1       # internal-only: directions averaged per
    #                               estimate (variance reduction,
    #                               beyond-paper; paper cites Liu et al.
    #                               2018); bench/library knob
    lam: float = 1e-4             # internal-only: regularizer weight lambda
    #                               (paper constant)
    perturb_server: bool = True   # internal-only: also ZO-update w_0
    #                               (Eq. 17); losslessness bench toggles it
    codec: str = "f32"            # up-link payload codec for the c values
    #                               (core/exchange.py: f32|bf16|int8; --codec)
    dp: Optional[DPConfig] = None  # flag: --dp-epsilon — clip-then-noise
    #                               defense at the codec seam (dp/mechanisms.py;
    #                               None = undefended)
    fused: bool = False           # route releases through the fused
    #                               kernels/fused_round fast path (bitwise
    #                               equal to the unfused seam; --fused)


@dataclass(frozen=True)
class NetworkConfig:
    """Per-link channel model for the wire subsystem (core/wire.py).

    A message of ``n`` bytes on a link costs
    ``scale * (latency_s + n / bandwidth_Bps + U(0, jitter_s))`` seconds,
    where ``scale`` is the per-party link multiplier (``party_scale[m]``
    for party m's link, 1.0 past the tuple's end). The defaults are the
    paper's Table-3 channel constants, so the 'lan' profile reproduces the
    paper's time ratios from measured message bytes.
    """
    name: str = "lan"
    latency_s: float = 5e-5       # per-message (Table 3's channel model)
    bandwidth_Bps: float = 1e8
    jitter_s: float = 0.0         # uniform [0, jitter_s) extra per message
    party_scale: Optional[Tuple[float, ...]] = None


NETWORK_PROFILES = {
    "lan": NetworkConfig("lan"),
    # trans-continental WAN: 20ms latency, 10 Mbit/s, 2ms jitter
    "wan": NetworkConfig("wan", latency_s=2e-2, bandwidth_Bps=1.25e6,
                         jitter_s=2e-3),
    # LAN where party 0's link is 6x slower (Fig 3's straggler, as a
    # network property instead of a compute multiplier)
    "straggler": NetworkConfig("straggler", party_scale=(6.0,)),
}


@dataclass(frozen=True)
class RuntimeConfig:
    """Knobs of the multi-process TCP federation runtime (runtime/), the
    reference's fields and defaults.

    ``schedule`` picks the server's dispatch order: 'serial' processes
    party rounds in strict round-robin (the deterministic reference,
    bitwise ``HostAsyncTrainer.run_serial``), 'arrival' processes complete
    rounds in the order they arrive off the sockets (AsyREVEL: fast
    parties never wait for stragglers). ``max_staleness`` enforces the
    paper's tau (Assumption 4) on 'arrival': a round more than tau rounds
    ahead of the slowest party is parked until the laggard catches up
    (None = off). ``trace_dir`` and ``monitor`` are the reference's trace
    capture and live health plane (repro_torch/obs).
    """
    host: str = "127.0.0.1"       # internal-only: loopback federation;
    #                               launch/train.py spawns all processes
    port: int = 0                 # internal-only: 0 = OS-assigned
    #                               (reported to parties via the port queue)
    schedule: str = "serial"      # internal-only: serial | arrival dispatch
    #                               order (runtime tests set it directly)
    max_staleness: Optional[int] = None   # internal-only: tau (Assumption
    #                               4); None = off; test knob
    request_timeout_s: float = 15.0   # internal-only: per recv on an open
    #                               connection
    max_retries: int = 4          # internal-only: reply waits before a
    #                               party gives up
    connect_retries: int = 60     # internal-only: dial attempts (server
    #                               may start late)
    connect_backoff_s: float = 0.25   # internal-only: dial backoff seconds
    heartbeat_s: float = 2.0      # internal-only: party pings when a reply
    #                               is this late
    ckpt_every: int = 1           # internal-only: checkpoint cadence in
    #                               rounds; --ckpt-dir turns persistence on
    compute_cost_s: float = 0.0   # internal-only: simulated local compute
    #                               per round
    deadline_s: float = 300.0     # internal-only: hard wall for the whole
    #                               federation, derived from --steps
    trace_dir: Optional[str] = None   # flag: --trace — per-process JSONL
    #                               trace capture dir (repro_torch/obs);
    #                               None = tracing off
    monitor: bool = False         # flag: --monitor — live health plane:
    #                               the parent runs an obs.monitor
    #                               collector that the children stream to
    #                               (requires trace_dir)


@dataclass(frozen=True)
class ServingConfig:
    """Knobs of the federated inference front end (serving/federated.py).

    One engine step serves every occupied slot with ONE ``serve_down``
    query per party and one batched ``c_up`` answer back: per-message
    latency and codec overhead amortize over ``slots`` concurrent
    requests.
    """
    requests: int = 0             # flag: --serve — how many inference
    #                               requests to serve (0 = serving off)
    slots: int = 8                # flag: --serve-batch — concurrent
    #                               request slots = max wire batch B
    cache_entries: int = 2048     # flag: --serve-cache — per-party LRU
    #                               answer-cache capacity, keyed
    #                               (sample id, params version)


@dataclass(frozen=True)
class TrainConfig:
    """The first-order trainer's knobs (the reference's TrainConfig)."""
    batch_size: int = 8
    seq_len: int = 128
    steps: int = 100
    lr: float = 3e-4
    optimizer: str = "adam"       # adam | sgd | zo_sgd
    schedule: str = "constant"    # constant | cosine | wsd
    warmup_steps: int = 10
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    seed: int = 0
    log_every: int = 10
