"""EVE, the Bayesian VAE over MSA one-hots (counterpart of
proteingym_tpu/models/eve.py): the model, its training and its scoring.

Semantics match the reference EVE (ref proteingym/baselines/EVE/EVE/
VAE_model.py, VAE_encoder.py, VAE_decoder.py) as the JAX package has them:

- encoder: a ReLU MLP (2000-1000-300 by default) to the mean and log
  variance of a z_dim=50 latent;
- decoder: a Bayesian ReLU MLP (300-1000-2000) whose every weight is drawn
  from its (mean, log variance) at each forward, an optional 1x1 output
  convolution (depth 40) applied through the reference's
  ``.view(channel, alphabet)`` of the (alphabet, channel) weight (a memory
  reinterpretation, not a transpose), optional sparsity tiles, a softplus
  temperature; the output is a log-softmax over (L, q);
- loss: the mean negative ELBO of a batch, whose "BCE" is sigmoid BCE on
  the log-softmax output (the reference's quirk), plus the latent KL and
  the decoder parameters' KL over Neff, both scaled by the warm-up;
- training: Adam steps on batches of 256 rows drawn with replacement in
  proportion to the sequence weights;
- scoring: evol_index = -(mean ELBO(mutant) - mean ELBO(WT)) over
  ``num_samples`` draws.

Parameter names follow the reference's ``model_state_dict``, so a
reference checkpoint file loads by name. Everything is float32. Draws come
from an explicit ``torch.Generator``; ``decode``, ``loss_fn`` and
``train_step`` also take them as tensors (``draw_noise``'s layout), so a
test can hand them any noise.
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from proteingym_tpu_torch.data.mutants import parse_mutant
from proteingym_tpu_torch.devices import adam, no_tf32, resolve_device, seeded_generator
from proteingym_tpu_torch.models.state_dict import copy_state_dict

ALPHABET = "ACDEFGHIKLMNPQRSTVWY"


@dataclasses.dataclass(frozen=True)
class EveConfig:
    seq_len: int
    alphabet_size: int = 20
    encoder_hidden: Tuple[int, ...] = (2000, 1000, 300)
    decoder_hidden: Tuple[int, ...] = (300, 1000, 2000)
    z_dim: int = 50
    convolve_output: bool = True
    convolution_depth: int = 40
    include_temperature_scaler: bool = True
    include_sparsity: bool = False
    num_tiles_sparsity: int = 0
    mu_bias_init: float = 0.1
    logvar_init: float = -10.0

    @property
    def channel(self) -> int:
        return self.convolution_depth if self.convolve_output else self.alphabet_size


class Encoder(nn.Module):
    def __init__(self, c: EveConfig, device=None):
        super().__init__()
        dims = (c.seq_len * c.alphabet_size,) + tuple(c.encoder_hidden)
        self.hidden_layers = nn.ModuleList(nn.Linear(a, b, device=device)
                                           for a, b in zip(dims, dims[1:]))
        self.fc_mean = nn.Linear(dims[-1], c.z_dim, device=device)
        self.fc_log_var = nn.Linear(dims[-1], c.z_dim, device=device)


class Decoder(nn.Module):
    def __init__(self, c: EveConfig, device=None):
        super().__init__()
        dims = (c.z_dim,) + tuple(c.decoder_hidden)
        self.hidden_layers_mean = nn.ModuleList(nn.Linear(a, b, device=device)
                                                for a, b in zip(dims, dims[1:]))
        self.hidden_layers_log_var = nn.ModuleList(nn.Linear(a, b, device=device)
                                                   for a, b in zip(dims, dims[1:]))
        out_rows, hidden = c.channel * c.seq_len, dims[-1]
        p = lambda *shape: nn.Parameter(torch.empty(shape, device=device))
        self.last_hidden_layer_weight_mean = p(out_rows, hidden)
        self.last_hidden_layer_weight_log_var = p(out_rows, hidden)
        self.last_hidden_layer_bias_mean = p(c.seq_len * c.alphabet_size)
        self.last_hidden_layer_bias_log_var = p(c.seq_len * c.alphabet_size)
        if c.convolve_output:
            self.output_convolution_mean = nn.Conv1d(c.channel, c.alphabet_size, 1,
                                                     bias=False, device=device)
            self.output_convolution_log_var = nn.Conv1d(c.channel, c.alphabet_size, 1,
                                                        bias=False, device=device)
        if c.include_sparsity:
            tiles = hidden // c.num_tiles_sparsity
            self.sparsity_weight_mean = p(tiles, c.seq_len)
            self.sparsity_weight_log_var = p(tiles, c.seq_len)
        if c.include_temperature_scaler:
            self.temperature_scaler_mean = p(1)
            self.temperature_scaler_log_var = p(1)


class EveModel(nn.Module):
    """EVE's encoder and Bayesian decoder, under the reference's names."""

    def __init__(self, config: EveConfig, device=None):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config, device)
        self.decoder = Decoder(config, device)

    def encode(self, x: torch.Tensor):
        """x: (B, L, q) one-hot -> (mu, logvar), each (B, z_dim)."""
        h = x.reshape(x.shape[0], -1)
        for layer in self.encoder.hidden_layers:
            h = torch.relu(layer(h))
        return self.encoder.fc_mean(h), self.encoder.fc_log_var(h)

    def variational(self) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """The decoder's (mean, log variance) pairs in the order the JAX
        ``decode`` draws them: each hidden layer's weight and bias, the
        output weight and bias, then the convolution, the sparsity tiles
        and the temperature where the model has them. Convolution weights
        are (alphabet, channel)."""
        c, dec = self.config, self.decoder
        pairs = []
        for mean, log_var in zip(dec.hidden_layers_mean, dec.hidden_layers_log_var):
            pairs += [(mean.weight, log_var.weight), (mean.bias, log_var.bias)]
        pairs += [(dec.last_hidden_layer_weight_mean, dec.last_hidden_layer_weight_log_var),
                  (dec.last_hidden_layer_bias_mean, dec.last_hidden_layer_bias_log_var)]
        if c.convolve_output:
            pairs.append((dec.output_convolution_mean.weight[..., 0],
                          dec.output_convolution_log_var.weight[..., 0]))
        if c.include_sparsity:
            pairs.append((dec.sparsity_weight_mean, dec.sparsity_weight_log_var))
        if c.include_temperature_scaler:
            pairs.append((dec.temperature_scaler_mean, dec.temperature_scaler_log_var))
        return pairs

    def draw_noise(self, n_draws: int, generator: torch.Generator) -> List[torch.Tensor]:
        """Unit-normal noise for ``n_draws`` decoder draws: one (n_draws,
        *shape) tensor per pair of ``variational()``."""
        return [torch.randn((n_draws, *mean.shape), generator=generator, device=mean.device)
                for mean, _ in self.variational()]

    def decode(self, z: torch.Tensor, generator: Optional[torch.Generator] = None,
               noise: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """Bayesian decoder: z (S, B, z_dim) -> (S, B, L, q) log-softmax,
        draw s taking its own sample of every decoder weight, mean +
        exp(logvar / 2) * noise, the noise from ``noise`` (``draw_noise``'s
        layout, S draws) or else from ``generator``."""
        c = self.config
        s = z.shape[0]
        if noise is None:
            noise = self.draw_noise(s, generator)
        draws = iter(torch.addcmul(mean, torch.exp(0.5 * log_var), eps)
                     for (mean, log_var), eps in zip(self.variational(), noise))
        h = z
        for _ in self.decoder.hidden_layers_mean:
            w, b = next(draws), next(draws)
            h = torch.relu(torch.bmm(h, w.transpose(1, 2)) + b[:, None])
        w_out, b_out = next(draws), next(draws)
        hidden = c.decoder_hidden[-1]
        if c.convolve_output:
            # (L*H, channel) @ (channel, q): the raw reinterpretation of the
            # (q, channel) weight as (channel, q) (ref VAE_decoder.py:146-148)
            conv_w = next(draws).reshape(s, c.channel, c.alphabet_size)
            w_out = torch.bmm(w_out.reshape(s, c.seq_len * hidden, c.channel), conv_w)
        if c.include_sparsity:
            sp = torch.sigmoid(next(draws).repeat(1, c.num_tiles_sparsity, 1))  # (S, H, L)
            w_out = w_out.reshape(s, hidden, c.seq_len, c.alphabet_size) * sp[..., None]
        w_out = w_out.reshape(s, c.seq_len * c.alphabet_size, hidden)
        logits = torch.bmm(h, w_out.transpose(1, 2)) + b_out[:, None]
        if c.include_temperature_scaler:
            temp = next(draws)[:, 0]
            logits = torch.log(1.0 + torch.exp(temp))[:, None, None] * logits
        logits = logits.reshape(s, -1, c.seq_len, c.alphabet_size)
        return torch.log_softmax(logits, dim=-1)


# ---------------------------------------------------------------------------
# Loss pieces and scoring
# ---------------------------------------------------------------------------

def _bce_with_logits(logits, targets):
    """torch's binary_cross_entropy_with_logits, elementwise, as the JAX
    package writes it."""
    return torch.clamp(logits, min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def kld_latent(mu, logvar):
    """Per-sequence KL(q(z|x) || N(0, I)) (ref VAE_model.py:156)."""
    return -0.5 * torch.sum(1 + logvar - mu ** 2 - torch.exp(logvar), dim=-1)


@torch.no_grad()
def mean_elbos(model: EveModel, onehots: np.ndarray, num_samples: int = 20_000,
               chunk: int = 4, seed: int = 0) -> np.ndarray:
    """Mean ELBO per sequence over ``ceil(num_samples / chunk) * chunk``
    draws (ref VAE_model.py:466-477), float32 (N,).

    The encoder and the latent KL run once; each step draws ``chunk``
    latents for every sequence and ``chunk`` samples of the decoder
    weights from a generator seeded ``seed``, and adds the BCE summed over
    the draws. Throughput comes from the batch axis: one weight draw
    serves every sequence, so callers pass a whole assay at once."""
    device = next(model.parameters()).device
    x = torch.as_tensor(np.asarray(onehots, dtype=np.float32), device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    mu, logvar = model.encode(x)
    std = torch.exp(0.5 * logvar)
    kld = kld_latent(mu, logvar)
    x_flat = x.reshape(x.shape[0], -1)
    chunk = max(1, chunk)
    n_draws = -(-num_samples // chunk) * chunk
    bce_total = torch.zeros(x.shape[0], device=device)
    for _ in range(n_draws // chunk):
        z = mu + std * torch.randn((chunk, *mu.shape), generator=gen, device=device)
        recon = model.decode(z, generator=gen).reshape(chunk, x.shape[0], -1)
        bce_total += _bce_with_logits(recon, x_flat).sum(dim=2).sum(dim=0)
    return (-(bce_total / n_draws + kld)).cpu().numpy()


def evol_indices(model: EveModel, wt_onehot: np.ndarray, mut_onehots: np.ndarray,
                 num_samples: int = 20_000, chunk: int = 4, seed: int = 0) -> np.ndarray:
    """evol_index = -(mean_ELBO(mutant) - mean_ELBO(WT)) (ref :478-481);
    higher is more deleterious (the registry's EVE directionality is -1)."""
    batch = np.concatenate([wt_onehot[None], mut_onehots], axis=0)
    elbos = mean_elbos(model, batch, num_samples, chunk, seed)
    return -(elbos[1:] - elbos[0])


def onehot_sequence(seq: str, alphabet: str = ALPHABET) -> np.ndarray:
    """(L, q) float32 one-hot of the upper-cased letters; a letter outside
    ``alphabet`` is an all-zero row."""
    idx = {a: i for i, a in enumerate(alphabet)}
    out = np.zeros((len(seq), len(alphabet)), dtype=np.float32)
    for j, ch in enumerate(seq.upper()):
        if ch in idx:
            out[j, idx[ch]] = 1.0
    return out


def onehot_mutants(focus_codes: np.ndarray, mutants, alphabet: str,
                   aa_to_idx=None) -> np.ndarray:
    """(M, L, q) float32 one-hots of mutant strings in focus coordinates;
    a focus letter of code -1 (indeterminate) is an all-zero row."""
    if aa_to_idx is None:
        aa_to_idx = {a: i for i, a in enumerate(alphabet)}
    q = len(alphabet)
    focus_codes = np.asarray(focus_codes)
    base = np.zeros((len(focus_codes), q), dtype=np.float32)
    known = focus_codes >= 0
    base[known, focus_codes[known]] = 1.0
    out = np.repeat(base[None], len(mutants), axis=0)
    for i, m in enumerate(mutants):
        for _, pos, t in parse_mutant(m):
            out[i, pos - 1] = 0.0
            out[i, pos - 1, aa_to_idx[t]] = 1.0
    return out


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

BATCH_SIZE = 256  # rows per step, drawn with replacement by sequence weight


def _kld_diag_gaussians(mu, logvar, p_mu=0.0, p_logvar=0.0):
    """KL(q || p) of diagonal Gaussians, summed (ref VAE_model.py:74-81)."""
    return torch.sum(0.5 * (p_logvar - logvar)
                     + 0.5 * (torch.exp(logvar) + (mu - p_mu) ** 2) / (math.exp(p_logvar) + 1e-20)
                     - 0.5)


def kld_decoder_params(model: EveModel) -> torch.Tensor:
    """KL of every decoder (mean, log variance) pair against its prior
    (ref VAE_model.py:92-147): N(0, 1), except the sparsity tiles', whose
    logits have the prior N(sqrt(2) * 4 * erfinv(2 * 0.01 - 1), 4^2)."""
    sparsity = getattr(model.decoder, "sparsity_weight_mean", None)
    sigma = 4.0
    sparsity_mu = math.sqrt(2.0) * sigma * float(
        torch.special.erfinv(torch.tensor(2.0 * 0.01 - 1.0, dtype=torch.float64)))
    total = 0.0
    for mean, log_var in model.variational():
        if mean is sparsity:
            total = total + _kld_diag_gaussians(mean, log_var, sparsity_mu, math.log(sigma ** 2))
        else:
            total = total + _kld_diag_gaussians(mean, log_var)
    return total


def elbo_components(model: EveModel, x: torch.Tensor, z_noise=None, decoder_noise=None,
                    generator: Optional[torch.Generator] = None):
    """Per-sequence (ELBO, BCE, latent KL) of a (B, L, q) batch at one
    draw (ref all_likelihood_components, VAE_model.py:466-481): the latent
    noise ``z_noise`` (B, z_dim) and the decoder's ``decoder_noise``
    (``draw_noise(1, ...)``'s layout), each drawn from ``generator`` when
    not given."""
    mu, logvar = model.encode(x)
    if z_noise is None:
        z_noise = torch.randn(mu.shape, generator=generator, device=mu.device)
    z = mu + torch.exp(0.5 * logvar) * z_noise
    recon = model.decode(z[None], generator=generator, noise=decoder_noise)[0]
    flat = x.reshape(x.shape[0], -1)
    bce = _bce_with_logits(recon.reshape(flat.shape), flat).sum(dim=1)
    kld = kld_latent(mu, logvar)
    return -(bce + kld), bce, kld


def loss_fn(model: EveModel, x: torch.Tensor, neff: float, warm_up_scale: float = 1.0,
            z_noise=None, decoder_noise=None, generator: Optional[torch.Generator] = None):
    """The mean negative ELBO plus the warm-up-scaled KL terms (ref
    VAE_model.py:149-163): returns ``neg_elbo`` and ``(bce_mean, kld_mean,
    kld_params_norm)``, the decoder parameters' KL over ``neff``."""
    _, bce, kld = elbo_components(model, x, z_noise, decoder_noise, generator)
    bce_mean, kld_mean = bce.mean(), kld.mean()
    kld_params_norm = kld_decoder_params(model) / neff
    neg_elbo = bce_mean + warm_up_scale * (kld_mean + kld_params_norm)
    return neg_elbo, (bce_mean, kld_mean, kld_params_norm)


def train_step(model: EveModel, optimizer: torch.optim.Optimizer, x: torch.Tensor, neff: float,
               z_noise=None, decoder_noise=None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One Adam step on the batch ``x`` (B, L, q) at warm-up scale 1, as
    the JAX ``train`` runs its step, the products in float32 without TF32;
    returns the loss before the update, on the device."""
    optimizer.zero_grad(set_to_none=True)
    with no_tf32():
        loss, _ = loss_fn(model, x, neff, 1.0, z_noise, decoder_noise, generator)
        loss.backward()
    optimizer.step()
    return loss.detach()


def train(onehot: np.ndarray, weights: np.ndarray, config: EveConfig, steps: int = 400_000,
          learning_rate: float = 1e-4, seed: int = 0, device="cuda") -> EveModel:
    """Train EVE on (N, L, q) one-hots with their sequence weights:
    ``steps`` Adam steps from a random init, each on ``BATCH_SIZE`` rows
    drawn with replacement in proportion to the weights, Neff their sum,
    no warm-up (ref train_VAE.py, as the JAX ``train`` runs it). The
    initial weights and every draw of the training come from one
    generator, stream 1 of ``seed`` on ``device`` (``seeded_generator``),
    so they replay neither ``init_random(seed=seed)`` nor the draws of a
    scoring seeded ``seed``. The losses stay on the device until the end,
    where they become ``model.losses`` (the loss before each update). The
    model comes back in inference mode, without gradients."""
    dev = resolve_device(device)
    gen = seeded_generator(seed, dev, stream=1)
    model = init_random(config, device=dev, generator=gen).requires_grad_(True)
    rows = torch.as_tensor(np.asarray(onehot, dtype=np.float32), device=dev)
    w = np.asarray(weights, dtype=np.float64)
    probs = torch.as_tensor(w / w.sum(), dtype=torch.float32, device=dev)
    neff = float(w.sum())
    optimizer = adam(model, learning_rate)
    losses = torch.empty(steps, device=dev)
    for step in range(steps):
        idx = torch.multinomial(probs, BATCH_SIZE, replacement=True, generator=gen)
        losses[step] = train_step(model, optimizer, rows[idx], neff, generator=gen)
    del optimizer, rows
    model.losses = losses.cpu().numpy().astype(np.float64)
    return model.requires_grad_(False)


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

def _empty_model(config: EveConfig, device) -> EveModel:
    with torch.device("meta"):
        model = EveModel(config)
    return model.to_empty(device=resolve_device(device)).eval().requires_grad_(False)


@torch.no_grad()
def init_random(config: EveConfig, seed: int = 0, device="cuda",
                generator: Optional[torch.Generator] = None) -> EveModel:
    """Seeded random init with the JAX ``init_params`` distribution (the
    draws differ): dense and convolution means U(-1/sqrt(fan_in), +), the
    output weight mean Xavier-normal, mean biases 0.1 (the latent log
    variance's -10), every decoder log variance -10, the temperature mean
    1, the sparsity means 0. The draws come from ``generator`` when it is
    given (a generator on ``device``), else from one seeded ``seed``."""
    c = config
    model = _empty_model(config, device)
    dev = model.decoder.last_hidden_layer_bias_mean.device
    gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(seed)

    def uniform(p, fan_in):
        bound = 1.0 / float(np.sqrt(fan_in))
        p.copy_((torch.rand(tuple(p.shape), generator=gen, device=dev) * 2 - 1) * bound)

    enc, dec = model.encoder, model.decoder
    for layer in [*enc.hidden_layers, enc.fc_mean, enc.fc_log_var, *dec.hidden_layers_mean]:
        uniform(layer.weight, layer.weight.shape[1])
        layer.bias.fill_(c.mu_bias_init)
    enc.fc_log_var.bias.fill_(c.logvar_init)
    for layer in dec.hidden_layers_log_var:
        layer.weight.fill_(c.logvar_init)
        layer.bias.fill_(c.logvar_init)
    w = dec.last_hidden_layer_weight_mean
    std = float(np.sqrt(2.0 / (w.shape[0] + w.shape[1])))
    w.copy_(torch.randn(tuple(w.shape), generator=gen, device=dev) * std)
    dec.last_hidden_layer_weight_log_var.fill_(c.logvar_init)
    dec.last_hidden_layer_bias_mean.fill_(c.mu_bias_init)
    dec.last_hidden_layer_bias_log_var.fill_(c.logvar_init)
    if c.convolve_output:
        uniform(dec.output_convolution_mean.weight, c.channel)
        dec.output_convolution_log_var.weight.fill_(c.logvar_init)
    if c.include_sparsity:
        dec.sparsity_weight_mean.zero_()
        dec.sparsity_weight_log_var.fill_(c.logvar_init)
    if c.include_temperature_scaler:
        dec.temperature_scaler_mean.fill_(1.0)
        dec.temperature_scaler_log_var.fill_(c.logvar_init)
    return model


def load_state_dict(state_dict: Mapping, config: EveConfig, device="cuda") -> EveModel:
    """The model from a reference ``model_state_dict``; a key it needs and
    does not find, or one of another shape, raises."""
    return copy_state_dict(_empty_model(config, device), state_dict, "EVE")


def config_from_torch_checkpoint(ckpt: Dict[str, Any]) -> EveConfig:
    """An EveConfig from a reference EVE checkpoint dict
    ({model_state_dict, encoder_parameters, decoder_parameters, ...}, ref
    VAE_model.py:356-364)."""
    enc, dec = ckpt["encoder_parameters"], ckpt["decoder_parameters"]
    if enc.get("convolve_input"):
        raise NotImplementedError("convolve_input encoders are not used by published EVE models")
    if enc.get("nonlinear_activation", "relu") != "relu":
        raise NotImplementedError(f"encoder nonlinear_activation="
                                  f"{enc['nonlinear_activation']!r} unsupported")
    for k in ("first_hidden_nonlinearity", "last_hidden_nonlinearity"):
        if dec.get(k, "relu") != "relu":
            raise NotImplementedError(f"decoder {k}={dec[k]!r} unsupported")
    w0 = ckpt["model_state_dict"]["encoder.hidden_layers.0.weight"]
    alphabet_size = int(enc.get("alphabet_size", 20))
    return EveConfig(
        seq_len=int(enc.get("seq_len", w0.shape[1] // alphabet_size)),
        alphabet_size=alphabet_size,
        encoder_hidden=tuple(enc["hidden_layers_sizes"]),
        decoder_hidden=tuple(dec["hidden_layers_sizes"]),
        z_dim=int(enc["z_dim"]),
        convolve_output=bool(dec["convolve_output"]),
        convolution_depth=int(dec.get("convolution_output_depth", 40)),
        include_temperature_scaler=bool(dec["include_temperature_scaler"]),
        include_sparsity=bool(dec["include_sparsity"]),
        num_tiles_sparsity=int(dec.get("num_tiles_sparsity", 0)),
    )


def load_torch_checkpoint(path, device="cuda") -> Tuple[EveModel, EveConfig]:
    """A reference EVE checkpoint file (torch.save of the dict above)."""
    # the file pickles its parameter dicts beside the weights, which
    # weights_only loading refuses; load only checkpoints you trust
    ckpt = torch.load(Path(path), map_location="cpu", weights_only=False)
    config = config_from_torch_checkpoint(ckpt)
    return load_state_dict(ckpt["model_state_dict"], config, device=device), config


def checkpoint_dict(model: EveModel) -> Dict[str, Any]:
    """The model as a reference checkpoint dict, which ``torch.save``
    writes as a file ``load_torch_checkpoint`` (and the JAX package's)
    reads."""
    c = model.config
    return {
        "model_state_dict": {k: v.detach().cpu() for k, v in model.state_dict().items()},
        "encoder_parameters": {
            "seq_len": c.seq_len, "alphabet_size": c.alphabet_size,
            "hidden_layers_sizes": list(c.encoder_hidden), "z_dim": c.z_dim,
            "convolve_input": False, "nonlinear_activation": "relu",
        },
        "decoder_parameters": {
            "seq_len": c.seq_len, "alphabet_size": c.alphabet_size,
            "hidden_layers_sizes": list(c.decoder_hidden), "z_dim": c.z_dim,
            "first_hidden_nonlinearity": "relu", "last_hidden_nonlinearity": "relu",
            "convolve_output": c.convolve_output,
            "convolution_output_depth": c.convolution_depth,
            "include_temperature_scaler": c.include_temperature_scaler,
            "include_sparsity": c.include_sparsity,
            "num_tiles_sparsity": c.num_tiles_sparsity,
        },
        "training_parameters": {},
    }


def params_from_jax(params, config: EveConfig) -> Dict[str, torch.Tensor]:
    """The JAX params pytree (numpy leaves) as a reference-named state
    dict (the inverse of the JAX ``convert_torch_state_dict``)."""
    sd: Dict[str, torch.Tensor] = {}

    def put(key, value):
        sd[key] = torch.from_numpy(np.array(value, dtype=np.float32))

    enc, dec = params["encoder"], params["decoder"]
    for i, layer in enumerate(enc["layers"]):
        put(f"encoder.hidden_layers.{i}.weight", layer["w"])
        put(f"encoder.hidden_layers.{i}.bias", layer["b"])
    for name, key in (("mean", "fc_mean"), ("logvar", "fc_log_var")):
        put(f"encoder.{key}.weight", enc[name]["w"])
        put(f"encoder.{key}.bias", enc[name]["b"])
    for i, layer in enumerate(dec["layers"]):
        put(f"decoder.hidden_layers_mean.{i}.weight", layer["w_mean"])
        put(f"decoder.hidden_layers_mean.{i}.bias", layer["b_mean"])
        put(f"decoder.hidden_layers_log_var.{i}.weight", layer["w_logvar"])
        put(f"decoder.hidden_layers_log_var.{i}.bias", layer["b_logvar"])
    put("decoder.last_hidden_layer_weight_mean", dec["w_out_mean"])
    put("decoder.last_hidden_layer_weight_log_var", dec["w_out_logvar"])
    put("decoder.last_hidden_layer_bias_mean", dec["b_out_mean"])
    put("decoder.last_hidden_layer_bias_log_var", dec["b_out_logvar"])
    if config.convolve_output:
        put("decoder.output_convolution_mean.weight", np.asarray(dec["conv_mean"])[..., None])
        put("decoder.output_convolution_log_var.weight",
            np.asarray(dec["conv_logvar"])[..., None])
    if config.include_sparsity:
        put("decoder.sparsity_weight_mean", dec["sparsity_mean"])
        put("decoder.sparsity_weight_log_var", dec["sparsity_logvar"])
    if config.include_temperature_scaler:
        put("decoder.temperature_scaler_mean", dec["temp_mean"])
        put("decoder.temperature_scaler_log_var", dec["temp_logvar"])
    return sd
