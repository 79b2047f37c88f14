"""Typed configuration tree for the whole framework.

Replaces the reference's three separate flag systems (per-task argparse
parsers ``finetune_src/{r2r,reverie,cvdn}/parser.py``, the legacy
``finetune_src/utils/parser.py``, and the pretrain JSON-with-CLI-override
``pretrain_src/utils/parser.py``) with one JSON-serializable dataclass
tree plus per-task presets mirroring ``finetune_src/scripts/*.sh``.

A copy of ``vln_hamt_tpu/configs/config.py`` so configs round-trip as
the same JSON in both packages. ``use_pallas_attention`` is kept for
that round trip and ignored by the port: on CUDA every attention runs
through the hand-written kernel. ``remat`` / ``remat_policy`` select the
port's activation recomputation (``agents/rollout.py:remat_step``);
``rng_impl`` is validated and recorded, and selects nothing
(``utils/misc.py``).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """HAMT model hyperparameters.

    Mirrors the reference model config (``pretrain_src/config/
    r2r_model_config.json`` consumed through HF ``PretrainedConfig`` in
    ``finetune_src/models/vlnbert_init.py:33-63``), re-expressed as a
    frozen dataclass so it is hashable.
    """

    vocab_size: int = 30522
    hidden_size: int = 768
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"  # erf-gelu, parity with vilmodel_cmt.py:22-28
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02

    # HAMT layer counts (vilmodel_cmt.py:426-452)
    num_l_layers: int = 9  # text self-attn layers
    num_r_layers: int = 0  # obs-only self-attn layers
    num_h_layers: int = 0  # history-only self-attn layers
    num_x_layers: int = 4  # cross-modal LXRTX layers
    num_h_pano_layers: int = 2  # panorama transformer in history embed

    # feature sizes
    image_feat_size: int = 768
    angle_feat_size: int = 4
    obj_feat_size: int = 0  # REVERIE object features (vlnbert_navref.py)
    obj_loc_size: int = 5  # normalized xyxy + area

    # capacity
    max_action_steps: int = 100  # history position table size

    # variants (vilmodel_cmt.py:701-726, model_HAMT.py:60-63)
    no_lang_ca: bool = False
    act_pred_token: str = "ob_txt"  # ob | ob_txt | ob_hist | ob_txt_hist
    hist_enc_pano: bool = True
    fix_lang_embedding: bool = False
    fix_hist_embedding: bool = False
    fix_obs_embedding: bool = False
    update_lang_bert: bool = True

    # head dropout
    pred_head_dropout_prob: float = 0.1
    feat_dropout: float = 0.4  # visual feature dropout (model_HAMT.py:18)
    critic_dropout: float = 0.5

    # pretraining heads (pretrain_src/model/pretrain_cmt.py)
    image_prob_size: int = 1000  # MRC soft-label classes

    # execution knobs (see module docstring)
    dtype: str = "float32"  # compute dtype: float32 | bfloat16
    use_pallas_attention: bool = False
    remat: bool = False  # recompute each rollout step's activations in backward
    remat_policy: str = "full"  # full | dots

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


@dataclass(frozen=True)
class EnvConfig:
    """Environment / episode shape parameters.

    Candidates and history are padded to these fixed maxima (the
    reference pads per-batch to the max, ``agent_cmt.py:137-149``), so
    every step of an episode has one shape.
    """

    dataset: str = "r2r"  # r2r | r2r_back | r2r_last | r4r | rxr | reverie | cvdn
    views: int = 36  # 12 headings x 3 elevations
    ob_type: str = "pano"  # pano (candidates + full panorama context) | cand
    max_action_len: int = 15
    max_instr_len: int = 60
    max_candidates: int = 14  # graph max degree + 1 STOP slot added on top
    max_objects: int = 20  # REVERIE
    angle_feat_size: int = 4
    image_feat_size: int = 768
    error_margin: float = 3.0  # SR threshold (env.py:19)
    multi_endpoints: bool = False  # REVERIE
    use_player_path: bool = False  # CVDN

    @property
    def num_ob_tokens(self) -> int:
        """Pano layout: candidates first, STOP, then remaining views.

        Candidate views overlap panorama views so the total is
        ``views + 1`` (36 pano slots + STOP), matching the reference's
        ``_cand_pano_feature_variable`` layout (agent_cmt.py:104-151).
        """
        return self.views + 1


@dataclass(frozen=True)
class TrainConfig:
    """Fine-tune training parameters (scripts/run_*.sh presets)."""

    batch_size: int = 8
    lr: float = 1e-5
    optim: str = "adamw"  # rms | adam | adamw | sgd
    weight_decay: float = 0.0
    iters: int = 300_000
    log_every: int = 2000
    grad_clip: float = 40.0
    feedback: str = "sample"  # teacher | sample | argmax
    ml_weight: float = 0.2
    teacher_weight: float = 1.0
    gamma: float = 0.9
    entropy_loss_weight: float = 0.01
    normalize_loss: str = "total"  # total | batch | none
    ignoreid: int = -100
    seed: int = 0
    # device-resident feature table for IL episode transport (ship
    # (B,T) node indices; gather features on device)
    feat_table: bool = True
    # parallelism: ('data', 'model') mesh shape for the fine-tune agent
    # (run/finetune.py builds the mesh and calls agent.enable_mesh)
    num_data_shards: int = 1  # data-parallel mesh axis
    model_shards: int = 1  # tensor-parallel mesh axis (TP rules, parallel/mesh.py)
    # checkpointing
    ckpt_dir: str = "ckpts"
    resume_file: Optional[str] = None
    resume_optimizer: bool = False
    # dropout PRNG name of the JAX package (validated and recorded by the
    # port, whose streams are the same under every name: utils/misc.py)
    rng_impl: str = "threefry2x32"

@dataclass(frozen=True)
class HAMTConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    env: EnvConfig = field(default_factory=EnvConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "HAMTConfig":
        raw = json.loads(text)
        return cls(
            model=ModelConfig(**raw.get("model", {})),
            env=EnvConfig(**raw.get("env", {})),
            train=TrainConfig(**raw.get("train", {})),
        )

    def replace(self, **sections: Dict[str, Any]) -> "HAMTConfig":
        """Return a copy with per-section field overrides.

        ``cfg.replace(model={"no_lang_ca": True}, train={"lr": 2e-5})``
        """
        updates = {}
        for name, overrides in sections.items():
            cur = getattr(self, name)
            updates[name] = dataclasses.replace(cur, **overrides)
        return dataclasses.replace(self, **updates)


def _preset(model=None, env=None, train=None) -> HAMTConfig:
    return HAMTConfig().replace(model=model or {}, env=env or {}, train=train or {})


# Per-task presets mirroring finetune_src/scripts/*.sh (SURVEY Appendix B).
PRESETS: Dict[str, HAMTConfig] = {
    # scripts/run_r2r.sh: vitbase 768-d, max_act 15 / instr 60, bs 8,
    # adamW 1e-5, 300k iters, fix lang+hist embedding, hist_enc_pano.
    "r2r": _preset(
        model={"fix_lang_embedding": True, "fix_hist_embedding": True},
        env={"dataset": "r2r", "max_action_len": 15, "max_instr_len": 60},
        train={"batch_size": 8, "iters": 300_000},
    ),
    # scripts/run_rxr.sh: CLIP 512-d feats, xlmr text, no_lang_ca.
    "rxr": _preset(
        model={
            "image_feat_size": 512,
            "no_lang_ca": True,
            "vocab_size": 250002,  # xlm-roberta-base
            "max_position_embeddings": 514,
            # 2 even for XLM-R: the trunk's obs embedding uses token
            # type 1; the reference duplicates XLM-R's single row at
            # init (rxr_xlm_model_config.json:29, main_r2r.py:139-143)
            "type_vocab_size": 2,
        },
        env={
            "dataset": "rxr",
            "max_action_len": 20,
            "max_instr_len": 250,
            "image_feat_size": 512,
        },
        train={"batch_size": 8, "iters": 200_000},
    ),
    # scripts/run_r4r.sh
    "r4r": _preset(
        model={"no_lang_ca": True},
        env={"dataset": "r4r", "max_action_len": 30, "max_instr_len": 100},
        train={"batch_size": 4, "iters": 300_000},
    ),
    # scripts/run_r2r_back.sh
    "r2r_back": _preset(
        model={"fix_lang_embedding": True, "fix_hist_embedding": True},
        env={"dataset": "r2r_back", "max_action_len": 30, "max_instr_len": 60},
        train={"batch_size": 4, "iters": 300_000},
    ),
    # scripts/run_r2r_last.sh
    "r2r_last": _preset(
        model={"fix_lang_embedding": True, "fix_hist_embedding": True},
        env={"dataset": "r2r_last", "max_action_len": 15, "max_instr_len": 60},
        train={"batch_size": 8, "iters": 300_000},
    ),
    # scripts/run_reverie.sh: object grounding head, 20 objects.
    "reverie": _preset(
        model={"no_lang_ca": True, "obj_feat_size": 768},
        env={
            "dataset": "reverie",
            "max_action_len": 15,
            "max_instr_len": 60,
            "multi_endpoints": True,
        },
        train={"batch_size": 8, "iters": 200_000},
    ),
    # scripts/run_cvdn.sh
    "cvdn": _preset(
        model={"no_lang_ca": True},
        env={
            "dataset": "cvdn",
            "max_action_len": 30,
            "max_instr_len": 100,
            "use_player_path": True,
        },
        train={"batch_size": 4, "iters": 200_000},
    ),
}


def get_preset(name: str) -> HAMTConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; available: {sorted(PRESETS)}")
    return PRESETS[name]
