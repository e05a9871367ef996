"""Stage-II pretraining: the masked students, ACT_PointDistillation and
ACT_PointBERT.

Counterpart of ``act_tpu/models/act.py`` (reference models/act.py:148-309,
532-723, 913-1258). The distillation student's masks have a fixed count
``int(ratio * G)``, so the visible and masked token sets are index gathers of
a stable sort of the mask, in token order. The Point-BERT student
(``MaskTransformer``) keeps every token: its Bernoulli mask has a count that
varies from batch to batch and only weights a blend with the mask token. The
frozen tokenizer runs under ``torch.no_grad()`` in the model's own mode: in
training mode its BatchNorms take batch statistics (and update their running
ones) and its prompt dropout is live, as in the reference.

Random draws come from the generators in ``rngs``: 'mask' (masking, token
replacement and the mixup), 'gumbel' (the tokenizer's sample), 'dropout'
(prompt dropout) and 'droppath' (stochastic depth).
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from act_tpu_torch import ops
from act_tpu_torch.models.build import MODELS
from act_tpu_torch.models.common import (Dense, GroupEncoder, LayerNorm, PosEmbedMLP,
                                         Rngs, TransformerDecoder, TransformerEncoder,
                                         dtype_from_cfg, init_weights, rng,
                                         trunc_normal_)
from act_tpu_torch.models.dvae import stage_two_tokenizer
from act_tpu_torch.models.teacher import init_teacher_prompts
from act_tpu_torch.parallel import (all_gather_cat, all_reduce_sum, process_count,
                                    process_index)
from act_tpu_torch.parallel.mesh import rand_local, randint_local
from act_tpu_torch.utils.config import as_cfg


# ---------------------------------------------------------------------------
# masking (static mask counts)
# ---------------------------------------------------------------------------

def random_mask(generator: torch.Generator, batch: int, num_group: int,
                num_mask: int) -> torch.Tensor:
    """(B, G) bool with exactly ``num_mask`` True per row, uniformly at random
    (reference _mask_center_rand, models/act.py:244-267)."""
    scores = rand_local((batch, num_group), generator)
    return torch.argsort(torch.argsort(scores, dim=-1), dim=-1) < num_mask


def block_mask(generator: torch.Generator, center: torch.Tensor, num_mask: int
               ) -> torch.Tensor:
    """Mask the ``num_mask`` groups nearest to a random seed group
    (reference _mask_center_block, models/act.py:215-242)."""
    B, G, _ = center.shape
    seed_idx = randint_local(G, (B,), generator)
    seed = center[torch.arange(B, device=center.device), seed_idx][:, None, :]
    d = torch.sum((center - seed) ** 2, dim=-1)
    return torch.argsort(torch.argsort(d, dim=-1), dim=-1) < num_mask


def bernoulli_ratio_mask(generator: torch.Generator, batch: int, num_group: int,
                         lo: float, hi: float) -> torch.Tensor:
    """(B, G) bool: one ratio for the batch drawn from U[lo, hi), then each
    group masked with that probability (``act.py:59-67``; the reference
    MaskTransformer's per-batch ratio). The count varies."""
    ratio = lo + (hi - lo) * torch.rand((), generator=generator, device=generator.device)
    return rand_local((batch, num_group), generator) < ratio


def split_by_mask(mask: torch.Tensor, num_mask: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, G) bool -> (visible idx (B, G - num_mask), masked idx (B,
    num_mask)), each in token order (a stable sort on the 0/1 key)."""
    order = torch.argsort(mask.to(torch.int32), dim=-1, stable=True)
    G = mask.shape[1]
    return order[:, :G - num_mask], order[:, G - num_mask:]


def take_tokens(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, G, ...), idx (B, S) -> (B, S, ...)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


# ---------------------------------------------------------------------------
# distillation losses (reference models/act.py:1184-1195 via lightly)
# ---------------------------------------------------------------------------

def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-8)


def negative_cosine_loss(student: torch.Tensor, teacher: torch.Tensor) -> torch.Tensor:
    """Mean over all tokens of 1 - cos(student, teacher)."""
    return torch.mean(1.0 - torch.sum(_unit(student) * _unit(teacher), dim=-1))


def ntxent_loss(student: torch.Tensor, teacher: torch.Tensor,
                temperature: float = 0.07) -> torch.Tensor:
    """NT-Xent between corresponding tokens, per sample, in-sample negatives."""
    logits = torch.einsum("bmc,bnc->bmn", _unit(student), _unit(teacher)) / temperature
    return -torch.diagonal(F.log_softmax(logits, dim=-1), dim1=-2, dim2=-1).mean()


def barlow_twins_loss(student: torch.Tensor, teacher: torch.Tensor,
                      lambda_param: float = 5e-3) -> torch.Tensor:
    """Barlow Twins cross-correlation loss per sample, averaged over the batch."""
    m = student.shape[1]
    s = (student - student.mean(1, keepdim=True)) / (student.std(1, correction=0, keepdim=True) + 1e-5)
    t = (teacher - teacher.mean(1, keepdim=True)) / (teacher.std(1, correction=0, keepdim=True) + 1e-5)
    c = torch.einsum("bmi,bmj->bij", s, t) / m
    diag = torch.diagonal(c, dim1=-2, dim2=-1)
    on = torch.sum((diag - 1.0) ** 2, dim=-1)
    off = torch.sum(c ** 2, dim=(-2, -1)) - torch.sum(diag ** 2, dim=-1)
    return torch.mean(on + lambda_param * off)


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0
                   ) -> torch.Tensor:
    d = torch.abs(pred - target)
    return torch.mean(torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta))


LOSSES = {"cosine": negative_cosine_loss,
          "l2": lambda s, t: torch.mean((s - t) ** 2),
          "smoothl1": smooth_l1_loss, "ntxent": ntxent_loss, "barlow": barlow_twins_loss}


# ---------------------------------------------------------------------------
# the student
# ---------------------------------------------------------------------------

class VisableOnlyMaskTransformer(nn.Module):
    """MAE-style student: embed the visible groups, encode them with a cls
    token (reference models/act.py:148-309; the name keeps checkpoint-key
    parity). Under 'rand' masking only the visible groups are embedded, so
    train-mode BatchNorm statistics come from them (``act.py:150-159``)."""

    def __init__(self, config: Any):
        super().__init__()
        cfg = as_cfg(config)
        tc = cfg.transformer_config
        self.mask_ratio = tc.mask_ratio
        self.mask_type = tc.mask_type
        self.embed_dim = C = tc.embed_dim
        dtype = dtype_from_cfg(tc)
        enc = cfg.dvae_config.encoder_dims
        self.encoder = GroupEncoder(enc, dtype=dtype)
        self.use_reduce = enc != C
        if self.use_reduce:
            self.reduce_dim = Dense(enc, C)
        self.cls_token = nn.Parameter(torch.empty(1, 1, C))
        self.cls_pos = nn.Parameter(torch.empty(1, 1, C))
        self.pos_embed = PosEmbedMLP(C, dtype=dtype)
        self.blocks = TransformerEncoder(C, tc.depth, tc.num_heads, dtype=dtype,
                                         drop_path_rate=tc.drop_path_rate)
        self.norm = LayerNorm(C, eps=1e-5)
        # flax's default nn.gelu is the tanh form (act.py:122-123), in f32
        self.cls_head = nn.Sequential(Dense(C, tc.cls_dim), nn.GELU(approximate="tanh"),
                                      Dense(tc.cls_dim, tc.cls_dim))

    def make_mask(self, center: torch.Tensor, noaug: bool, rngs: Rngs
                  ) -> Tuple[torch.Tensor, int]:
        B, G, _ = center.shape
        num_mask = 0 if noaug else int(self.mask_ratio * G)
        if num_mask == 0:
            return torch.zeros(B, G, dtype=torch.bool, device=center.device), 0
        if self.mask_type == "rand":
            return random_mask(rng(rngs, "mask"), B, G, num_mask), num_mask
        return block_mask(rng(rngs, "mask"), center, num_mask), num_mask

    def forward(self, neighborhood: torch.Tensor, center: torch.Tensor,
                rngs: Rngs = None, noaug: bool = False, only_cls_tokens: bool = False,
                register_shallow_hook: int = -1, mask: Optional[torch.Tensor] = None):
        """-> cls feature (only_cls_tokens), else (visible tokens (B, V, C),
        mask) or, with a shallow hook, (visible, cls, hooked visible, mask).
        ``mask`` pins the (B, G) mask instead of drawing one."""
        B = center.shape[0]
        if mask is None:
            mask, num_mask = self.make_mask(center, noaug, rngs)
        else:
            num_mask = int(mask[0].sum())
        vis_idx, _ = split_by_mask(mask, num_mask)
        if self.mask_type == "block" and num_mask > 0:
            # a contiguous masked block would bias the BN statistics of the
            # visible subset: embed all groups, then gather (act.py:141-148)
            x_vis = take_tokens(self.encoder(neighborhood), vis_idx)
        else:
            x_vis = self.encoder(take_tokens(neighborhood, vis_idx))
        if self.use_reduce:
            x_vis = self.reduce_dim(x_vis)
        pos = self.pos_embed(take_tokens(center, vis_idx))
        x = torch.cat([self.cls_token.expand(B, -1, -1), x_vis], dim=1)
        pos = torch.cat([self.cls_pos.expand(B, -1, -1), pos], dim=1)
        hooks = (register_shallow_hook,) if register_shallow_hook > 0 else ()
        x, hidden = self.blocks(x, pos, rngs, return_hidden=hooks)
        x = self.norm(x)
        if only_cls_tokens:
            return self.cls_head(x[:, 0])
        if hooks:
            return x[:, 1:], x[:, 0], hidden[0][:, 1:], mask
        return x[:, 1:], mask


class MaskTransformer(nn.Module):
    """Point-BERT student: every group is embedded and kept, the masked ones
    blended with the mask token (reference models/act.py:532-723,
    ``act.py:185-289``); the q/k pair of ACT_PointBERT.

    The group encoder emits ``transformer_config.encoder_dims`` and
    ``reduce_dim`` always maps it to ``embed_dim`` (``use_reduce``). Both
    heads run on every forward: ``cls_head`` on the cls token, ``lm_head``
    (no compute dtype, so f32 logits) on the group tokens."""

    def __init__(self, config: Any, use_reduce: bool = True):
        super().__init__()
        cfg = as_cfg(config)
        tc = cfg.transformer_config
        r = tc.mask_ratio
        self.mask_ratio = tuple(r) if isinstance(r, (list, tuple)) else (r, r)
        self.replace_pob = float(tc.replace_pob)
        self.embed_dim = C = tc.embed_dim
        dtype = dtype_from_cfg(tc)
        enc = tc.encoder_dims
        self.encoder = GroupEncoder(enc, dtype=dtype)
        self.reduce_dim = Dense(enc, C) if use_reduce else nn.Identity()
        self.cls_token = nn.Parameter(torch.empty(1, 1, C))
        self.mask_token = nn.Parameter(torch.empty(1, 1, C))
        self.cls_pos = nn.Parameter(torch.empty(1, 1, C))
        self.pos_embed = PosEmbedMLP(C, dtype=dtype)
        self.blocks = TransformerEncoder(C, tc.depth, tc.num_heads, dtype=dtype,
                                         drop_path_rate=tc.drop_path_rate)
        self.norm = LayerNorm(C, eps=1e-5)
        self.lm_head = Dense(C, cfg.dvae_config.num_tokens)
        self.cls_head = nn.Sequential(Dense(C, tc.cls_dim), nn.GELU(approximate="tanh"),
                                      Dense(tc.cls_dim, tc.cls_dim))

    def make_mask(self, center: torch.Tensor, noaug: bool, rngs: Rngs) -> torch.Tensor:
        B, G, _ = center.shape
        lo, hi = self.mask_ratio
        if noaug or hi == 0:
            return torch.zeros(B, G, dtype=torch.bool, device=center.device)
        return bernoulli_ratio_mask(rng(rngs, "mask"), B, G, lo, hi)

    def random_replace(self, tokens: torch.Tensor, mask: torch.Tensor, noaug: bool,
                       rngs: Rngs) -> Tuple[torch.Tensor, torch.Tensor]:
        """BERT-style corruption (``act.py:242-257``): with probability
        ``replace_pob`` an unmasked token becomes a detached token drawn from
        the flattened batch by a random permutation. Returns the tokens and the
        overall mask (masked or replaced) that the token loss covers. Over R
        ranks the permutation runs over the global batch's R*B*G tokens (every
        rank draws it, so the generators stay in step) and each rank takes its
        rows of the permuted global tokens."""
        if noaug or self.replace_pob == 0:
            return tokens, mask
        B, G, C = tokens.shape
        g = rng(rngs, "mask")
        replace = (rand_local((B, G), g) < self.replace_pob) & ~mask
        perm = torch.randperm(process_count() * B * G, generator=g, device=g.device)
        rows = perm[process_index() * B * G:(process_index() + 1) * B * G]
        shuffled = all_gather_cat(tokens.detach()).reshape(-1, C)[rows].reshape(B, G, C)
        w = replace[:, :, None].to(tokens.dtype)
        return tokens * (1 - w) + shuffled * w, mask | replace

    def forward(self, neighborhood: torch.Tensor, center: torch.Tensor, rngs: Rngs = None,
                noaug: bool = False, only_cls_tokens: bool = False,
                mask: Optional[torch.Tensor] = None):
        """-> the cls feature (only_cls_tokens), else (cls feature (B,
        cls_dim), logits (B, G, num_tokens), overall mask (B, G)). ``mask``
        pins the (B, G) mask instead of drawing one."""
        B = center.shape[0]
        if mask is None:
            mask = self.make_mask(center, noaug, rngs)
        tokens = self.reduce_dim(self.encoder(neighborhood))
        tokens, overall_mask = self.random_replace(tokens, mask, noaug, rngs)
        w = mask[:, :, None].to(tokens.dtype)
        tokens = tokens * (1 - w) + self.mask_token.to(tokens.dtype) * w
        x = torch.cat([self.cls_token.expand(B, -1, -1), tokens], dim=1)
        pos = torch.cat([self.cls_pos.expand(B, -1, -1), self.pos_embed(center)], dim=1)
        x = self.norm(self.blocks(x, pos, rngs)[0])
        cls_feature = self.cls_head(x[:, 0])
        if only_cls_tokens:
            return cls_feature
        return cls_feature, self.lm_head(x[:, 1:]), overall_mask


class TokenAllMaskTransformer(MaskTransformer):
    """MaskTransformer whose group encoder emits ``embed_dim`` directly, with
    no ``reduce_dim`` (``act.py:294-298``; no registered model uses it)."""

    def __init__(self, config: Any):
        super().__init__(config, use_reduce=False)


# ---------------------------------------------------------------------------
# Stage-II pretrain model
# ---------------------------------------------------------------------------

@MODELS.register_module()
class ACT_PointDistillation(nn.Module):
    """Masked point modeling with latent-feature distillation from the frozen
    prompted dVAE teacher (reference models/act.py:1099-1258)."""

    def __init__(self, config: Any):
        super().__init__()
        cfg = as_cfg(config)
        tc = cfg.transformer_config
        self.embed_dim = C = tc.embed_dim
        self.mask_ratio = tc.mask_ratio
        self.num_group = cfg.dvae_config.num_group
        self.group_size = cfg.dvae_config.group_size
        if cfg.loss not in LOSSES:
            raise ValueError(f"unknown loss {cfg.loss}")
        self.loss_fn = LOSSES[cfg.loss]
        self.cls_loss = bool(tc.get("cls_loss", False))
        self.shallow_hook = int(tc.get("register_shallow_hook", -1))
        self.ACT_encoder = VisableOnlyMaskTransformer(cfg)
        self.dvae_tokenizer = stage_two_tokenizer(cfg.dvae_config)
        if tc.get("proj", "linear") in ("linear", "conv"):
            self.proj_head = Dense(C, cfg.dvae_config.tokens_dims)
        else:
            self.proj_head = nn.Identity()
        if self.mask_ratio > 0:
            self.mask_token = nn.Parameter(torch.empty(1, 1, C))
            self.decoder_pos_embed = PosEmbedMLP(C)
            self.ACT_decoder = TransformerDecoder(C, tc.decoder_depth, tc.decoder_num_heads,
                                                  drop_path_rate=tc.drop_path_rate,
                                                  dtype=dtype_from_cfg(tc))
        if self.cls_loss:
            self.cls_pos = nn.Parameter(torch.empty(1, 1, C))

    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded init with the JAX package's initializers: lecun-normal
        kernels, N(0, 1) codebook and student cls token/pos, truncated-normal
        (std 0.02) mask token and prompts."""
        init_weights(self, generator)
        with torch.no_grad():
            enc = self.ACT_encoder
            enc.cls_token.normal_(0.0, 1.0, generator=generator)
            enc.cls_pos.normal_(0.0, 1.0, generator=generator)
            self.dvae_tokenizer.codebook.normal_(0.0, 1.0, generator=generator)
            if self.mask_ratio > 0:
                trunc_normal_(self.mask_token, 0.02, generator)
            if self.cls_loss:
                self.cls_pos.normal_(0.0, 1.0, generator=generator)
        init_teacher_prompts(self.dvae_tokenizer, generator)

    def forward_eval(self, pts: torch.Tensor) -> torch.Tensor:
        """(B, N, 3) -> the student's cls feature (B, cls_dim), no masking."""
        neighborhood, center = ops.group_points(pts, self.num_group, self.group_size)
        return self.ACT_encoder(neighborhood, center, noaug=True, only_cls_tokens=True)

    def forward(self, pts: torch.Tensor, rngs: Rngs = None, noaug: bool = False,
                mask: Optional[torch.Tensor] = None,
                gumbel_u: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, N, 3) clouds -> the scalar distillation loss.

        ``mask`` (B, G) and ``gumbel_u`` (B, G, num_tokens) pin the draws,
        replaying the JAX model's sown intermediates."""
        if noaug:
            return self.forward_eval(pts)
        neighborhood, center = ops.group_points(pts, self.num_group, self.group_size)
        enc = self.ACT_encoder
        if self.cls_loss:
            x_vis, x_cls, x_shallow, mask = enc(neighborhood, center, rngs,
                                                register_shallow_hook=self.shallow_hook,
                                                mask=mask)
        else:
            x_vis, mask = enc(neighborhood, center, rngs, mask=mask)
        B, V, C = x_vis.shape
        num_mask = self.num_group - V
        with torch.no_grad():
            teacher_feat = self.dvae_tokenizer.forward_tokenizer_features(
                neighborhood, center, return_global=True, rngs=rngs, gumbel_u=gumbel_u)
        if num_mask == 0:
            # no decoder: distill the visible (= all) tokens (act.py:441-447)
            return self.loss_fn(self.proj_head(x_vis), teacher_feat)
        vis_idx, mask_idx = split_by_mask(mask, num_mask)
        pos_full = torch.cat([self.decoder_pos_embed(take_tokens(center, vis_idx)),
                              self.decoder_pos_embed(take_tokens(center, mask_idx))], dim=1)
        mask_tok = self.mask_token.expand(B, num_mask, C)
        x_rec = self.ACT_decoder(torch.cat([x_vis, mask_tok], dim=1), pos_full, num_mask, rngs)
        teacher_masked = take_tokens(teacher_feat, mask_idx)
        loss = self.loss_fn(self.proj_head(x_rec), teacher_masked)
        if self.cls_loss:
            x_shallow_full = torch.cat([x_cls[:, None, :], x_shallow, mask_tok], dim=1)
            pos_shallow = torch.cat([self.cls_pos.expand(B, 1, C), pos_full], dim=1)
            x_rec_shallow = self.ACT_decoder(x_shallow_full, pos_shallow, num_mask, rngs)
            loss = loss + self.loss_fn(self.proj_head(x_rec_shallow), teacher_masked)
        return loss


# ---------------------------------------------------------------------------
# ACT_PointBERT
# ---------------------------------------------------------------------------

def _normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x / (||x|| + 1e-12) along ``dim`` (``act.py:624-625``)."""
    return x / (torch.linalg.vector_norm(x, dim=dim, keepdim=True) + 1e-12)


def _ce_per_item(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logsumexp - the label's logit, per row: the cross entropy without the
    full log-softmax (``act.py:634-637``)."""
    lse = torch.logsumexp(logits, dim=-1)
    return lse - torch.gather(logits, -1, labels.long()[..., None])[..., 0]


def _ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean(_ce_per_item(logits, labels))


def _masked_ce(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor
               ) -> torch.Tensor:
    """The cross entropy at the masked positions of (B, G, V) logits, their
    mean weighted by the mask over max(mask count, 1) (``act.py:531-548``).
    Over R ranks the count is the global batch's (detached) and the loss R
    times this rank's share, so that the ranks' mean is the global loss and
    gradient (``train_state._update`` averages the gradients)."""
    w = mask.to(logits.dtype)
    total = all_reduce_sum(torch.sum(w).detach())
    return (torch.sum(_ce_per_item(logits, labels) * w) * process_count()
            / torch.clamp_min(total, 1.0))


@MODELS.register_module()
class ACT_PointBERT(nn.Module):
    """Point-BERT with the ACT tokenizer (reference models/act.py:913-1095,
    ``act.py:475-622``): the q and k MaskTransformers, the frozen dVAE whose
    argmax tokens label the masked groups, the point mixup and the MoCo
    queue. The forward returns (moco, dvae, cutmix) losses.

    The queue (cls_dim, K) and its pointer (1,) int64 are buffers in the
    reference's layout. Each loss forward reads a copy of the queue, then
    writes the normalised k features at the pointer (on the device, no host
    read) and advances it by B; K must be a multiple of B. The k encoder
    takes no gradient: the train step moves it by EMA
    (``train_state.pretrain_step``, ``ema_momentum``). Only the tokenizer's
    encoder and dgcnn_1 run; its other tensors keep the reference layout.

    Over R ranks of B clouds each the forward is the one-process forward on
    the global batch of R*B (rank order): the token replacement permutes
    the global tokens, the mixup flips the global batch, the cutmix
    positives are the global keys at the rank's global rows, the masked
    token loss divides by the global mask count, and every rank enqueues
    the global keys (the pointer advances by R*B), so the queue stays equal
    on every rank, as the EMA of k does."""

    def __init__(self, config: Any):
        super().__init__()
        cfg = as_cfg(config)
        tc = cfg.transformer_config
        self.T, self.K = float(cfg.T), int(cfg.K)
        self.moco_loss_on = bool(tc.moco_loss)
        self.dvae_loss_on = bool(tc.dvae_loss)
        self.cutmix_loss_on = bool(tc.cutmix_loss)
        self.return_all_tokens = bool(tc.return_all_tokens)
        self.cls_dim = int(tc.cls_dim)
        self.num_group = cfg.dvae_config.num_group
        self.group_size = cfg.dvae_config.group_size
        self.transformer_q = MaskTransformer(cfg)
        self.transformer_k = MaskTransformer(cfg)
        self.dvae = stage_two_tokenizer(cfg.dvae_config)
        self.register_buffer("queue", torch.empty(self.cls_dim, self.K))
        self.register_buffer("queue_ptr", torch.zeros(1, dtype=torch.long))

    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded init with the JAX package's initializers (lecun-normal
        kernels, N(0, 1) cls tokens and codebook, truncated-normal (std 0.02)
        mask tokens and prompts) and a queue of unit N(0, 1) columns drawn
        from ``generator`` (JAX draws its own from PRNGKey(0))."""
        init_weights(self, generator)
        with torch.no_grad():
            for enc in (self.transformer_q, self.transformer_k):
                enc.cls_token.normal_(0.0, 1.0, generator=generator)
                enc.cls_pos.normal_(0.0, 1.0, generator=generator)
                trunc_normal_(enc.mask_token, 0.02, generator)
            self.dvae.codebook.normal_(0.0, 1.0, generator=generator)
            self.queue.copy_(_normalize(torch.randn(self.cls_dim, self.K, generator=generator),
                                        dim=0))
            self.queue_ptr.zero_()
        init_teacher_prompts(self.dvae, generator)

    def forward_eval(self, pts: torch.Tensor) -> torch.Tensor:
        """(B, N, 3) -> transformer_q's cls feature (B, cls_dim), no masking."""
        neighborhood, center = ops.group_points(pts, self.num_group, self.group_size)
        return self.transformer_q(neighborhood, center, noaug=True, only_cls_tokens=True)

    def _mixup(self, neighborhood, center, dvae_label, rngs: Rngs, draws=None):
        """Point mixup with the batch flipped (``act.py:516-529``): a ratio
        a cloud and a Bernoulli(ratio) group mask, or ``draws`` = (ratio (B,),
        mask (B, G) float) pinned. Over R ranks the flip is the global
        batch's: rank r's row i pairs with rank R-1-r's row B-1-i, whose
        data (no gradient crosses ranks) come by an all-gather."""
        B, G = center.shape[:2]
        if draws is None:
            g = rng(rngs, "mask")
            ratio = rand_local((B,), g)
            mm = (rand_local((B, G), g) < ratio[:, None]
                  ).to(center.dtype)
        else:
            ratio, mm = draws
        r = process_index()

        def partner(t):
            return torch.flip(all_gather_cat(t), (0,))[r * B:(r + 1) * B]
        m4 = mm[:, :, None, None]
        mix_n = neighborhood * m4 + partner(neighborhood) * (1 - m4)
        mix_c = center * mm[:, :, None] + partner(center) * (1 - mm[:, :, None])
        mix_l = (dvae_label * mm + partner(dvae_label) * (1 - mm)).to(torch.int32)
        return ratio, mix_n, mix_c, mix_l

    def forward(self, pts: torch.Tensor, rngs: Rngs = None, noaug: bool = False,
                masks: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
                mixup: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        """(B, N, 3) clouds -> (moco, dvae, cutmix) losses; the queue and its
        pointer advance.

        ``masks`` = (q mask, mixup-pass mask, k mask) and ``mixup`` =
        (ratio, mask) pin the draws, replaying the JAX model's sown
        intermediates."""
        if noaug:
            return self.forward_eval(pts)
        B, R = pts.shape[0], process_count()
        if self.K % (R * B):
            raise ValueError(f"MoCo queue K={self.K} must be a multiple of the global batch "
                             f"{R} x {B}")
        mq, mmix, mk = masks if masks is not None else (None, None, None)
        neighborhood, center = ops.group_points(pts, self.num_group, self.group_size)
        with torch.no_grad():
            dvae_label = self.dvae.forward_tokenizer(neighborhood, center)
        q_cls, logits, mask = self.transformer_q(neighborhood, center, rngs, mask=mq)
        q_cls = _normalize(q_cls, dim=1)
        ratio, mix_n, mix_c, mix_l = self._mixup(neighborhood, center, dvae_label, rngs, mixup)
        mix_cls, mix_logits, mix_mask = self.transformer_q(mix_n, mix_c, rngs, mask=mmix)
        mix_cls = _normalize(mix_cls, dim=1)
        with torch.no_grad():
            k_cls = _normalize(self.transformer_k(neighborhood, center, rngs,
                                                  only_cls_tokens=True, mask=mk), dim=1)
        # autograd saves the queue for the backward of q @ queue: read a
        # copy, so that the in-place enqueue below does not change it
        queue = self.queue.clone()
        zero = torch.zeros((), device=pts.device)
        moco_loss = dvae_loss = cutmix_loss = zero
        if self.moco_loss_on:
            l_pos = torch.sum(q_cls * k_cls, dim=1, keepdim=True)
            ce = torch.cat([l_pos, q_cls @ queue], dim=1) / self.T
            moco_loss = _ce(ce, torch.zeros(B, dtype=torch.long, device=pts.device))
        if self.dvae_loss_on:
            if self.return_all_tokens:
                V = logits.shape[-1]
                dvae_loss = (_ce(logits.reshape(-1, V), dvae_label.reshape(-1))
                             + _ce(mix_logits.reshape(-1, V), mix_l.reshape(-1)))
            else:
                dvae_loss = (_masked_ce(logits, dvae_label, mask)
                             + _masked_ce(mix_logits, mix_l, mix_mask))
        k_all = all_gather_cat(k_cls)  # the global batch's keys, in rank order
        if self.cutmix_loss_on:
            ce = torch.cat([mix_cls @ k_all.T, mix_cls @ queue], dim=1) / self.T
            labels = process_index() * B + torch.arange(B, device=pts.device)
            cutmix_loss = torch.mean(ratio * _ce_per_item(ce, labels)
                                     + (1 - ratio) * _ce_per_item(ce, R * B - 1 - labels))
        self.enqueue(k_all)
        return moco_loss, dvae_loss, cutmix_loss

    @torch.no_grad()
    def enqueue(self, keys: torch.Tensor) -> None:
        """The (n, cls_dim) keys into the queue's columns from the pointer on
        (on the device, no host read); the pointer advances by n."""
        slots = self.queue_ptr + torch.arange(keys.shape[0], device=self.queue_ptr.device)
        self.queue.index_copy_(1, slots, keys.T.to(self.queue.dtype))
        self.queue_ptr.copy_((self.queue_ptr + keys.shape[0]) % self.K)
