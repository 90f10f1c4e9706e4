"""Model-zoo plumbing: trained-weight artifacts through the downloader.

The port's copy of ``mmlspark_tpu/models/zoo.py``. A parameter tree is
serialized to one npz payload plus a ``ModelSchema`` JSON, published into a
:class:`~mmlspark_tpu_torch.downloader.Repository` and loaded back with
hash verification; a small supervised trainer gives artifacts learned
weights without a download (train on local data, publish, transfer).

Payload format (the reference's, so a payload moves between the packages
in both directions): numpy ``.npz`` with ``/``-joined tree paths as keys;
LIST components are marked ``#i`` (so digit-keyed dicts round-trip
unchanged); lossless float32 round trip. Tensor leaves are written as
numpy arrays.
"""

from __future__ import annotations

import io
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from mmlspark_tpu_torch.core.pytree import to_numpy, tree_leaves, tree_map
from mmlspark_tpu_torch.device import float32_exact, resolve_device


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            # '#' marks LIST components below, '/' is the path separator —
            # dict keys using either would make the round trip ambiguous
            if "/" in str(k) or str(k).startswith("#"):
                raise ValueError(
                    f"zoo payload keys may not contain '/' or start with "
                    f"'#': {k!r}"
                )
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}#{i}/"))
    elif isinstance(tree, torch.Tensor):
        out[prefix[:-1]] = tree.detach().cpu().numpy()
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Any:
    root: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        # only explicitly-marked '#i' components become lists, so dicts
        # whose keys happen to be digit strings round-trip unchanged
        if node and all(k.startswith("#") for k in node):
            return [listify(node[f"#{i}"]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def params_to_bytes(params: Any) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **_flatten(params))
    return buf.getvalue()


def params_from_bytes(payload: bytes) -> Any:
    with np.load(io.BytesIO(payload)) as z:
        return _unflatten({k: z[k] for k in z.files})


def publish_model(
    repo_dir: str,
    name: str,
    params: Any,
    input_hw: Tuple[int, int],
    input_node: str = "image",
    extra: Optional[dict] = None,
) -> "ModelSchema":
    """Serialize ``params`` into ``repo_dir`` as ``<name>.bin`` +
    ``<name>.json`` (LocalRepo layout) and return the schema."""
    from mmlspark_tpu_torch.downloader.repository import LocalRepo, ModelSchema

    flat = _flatten(params)
    schema = ModelSchema(
        name=name,
        uri=f"{name}.bin",
        inputNode=f"{input_node}:{input_hw[0]}x{input_hw[1]}",
        numLayers=len(flat),
        layerNames=sorted(flat)[:64],
    )
    LocalRepo(repo_dir).add(schema, params_to_bytes(params))
    return schema


def load_zoo_params(downloader, name: str) -> Any:
    """Fetch a published artifact through the downloader (hash-verified,
    cached) and deserialize the parameter tree (numpy leaves)."""
    path = downloader.download_by_name(name)
    with open(path, "rb") as f:
        return params_from_bytes(f.read())


# ---------------------------------------------------------------------------
# Supervised trainer: learned weights for zoo artifacts without a download
# ---------------------------------------------------------------------------

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8


def adam_step(params, grads, mu, nu, step: int, learning_rate: float) -> None:
    """One Adam step in optax's form, in place: ``mu`` and ``nu`` are the
    moment lists, ``step`` counts from 1. ``mu = (1 - b1) g + b1 mu``,
    ``nu = (1 - b2) g^2 + b2 nu``, both bias-corrected by ``1 - b^step``
    (float32, as optax divides), and ``p -= lr * mu_hat / (sqrt(nu_hat) +
    eps)`` with eps added after the square root."""
    bc1 = 1 - torch.tensor(ADAM_B1, dtype=torch.float32) ** step
    bc2 = 1 - torch.tensor(ADAM_B2, dtype=torch.float32) ** step
    with torch.no_grad():
        for p, g, m, v in zip(params, grads, mu, nu):
            m.copy_((1 - ADAM_B1) * g + ADAM_B1 * m)
            v.copy_((1 - ADAM_B2) * (g * g) + ADAM_B2 * v)
            m_hat = m / bc1.to(m.device)
            v_hat = v / bc2.to(v.device)
            p.add_(-learning_rate * (m_hat / (torch.sqrt(v_hat) + ADAM_EPS)))


def _cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over integer labels (optax's
    ``softmax_cross_entropy_with_integer_labels``: the log-softmax at the
    label, negated)."""
    logp = torch.log_softmax(logits, dim=1)
    return -logp.gather(1, labels[:, None])[:, 0].mean()


def train_resnet_classifier(
    params: Any,
    X: np.ndarray,  # (N, C, H, W) float32 in [0, 1]
    y: np.ndarray,  # (N,) int class ids
    *,
    num_steps: int = 300,
    batch_size: int = 64,
    learning_rate: float = 1e-3,
    seed: int = 0,
    device: Any = None,
    losses: Optional[list] = None,
) -> Tuple[Any, float]:
    """Train the zoo ResNet's weights with Adam on softmax cross-entropy,
    as the reference does: every leaf of the tree is a trained parameter
    (the BatchNorm running stats too, since the folded affine reads them)
    and the apply function is the same in training and evaluation.
    Batches are drawn with ``default_rng(seed).integers``, the reference's
    draw. Runs on ``device`` (default the card). ``losses``, when given, is
    appended each step's loss. Returns (trained params as numpy, final
    train accuracy)."""
    dev = resolve_device(device)
    X = np.asarray(X, np.float32)
    y = np.asarray(y, np.int32)
    n = len(y)
    tree = tree_map(lambda a: torch.tensor(np.asarray(a), device=dev, requires_grad=True),
                    params)
    leaves = tree_leaves(tree)
    mu = [torch.zeros_like(p) for p in leaves]
    nu = [torch.zeros_like(p) for p in leaves]
    rng = np.random.default_rng(seed)
    with float32_exact():
        return _train(tree, leaves, mu, nu, rng, X, y, n, dev, num_steps, batch_size,
                      learning_rate, losses)


def _train(tree, leaves, mu, nu, rng, X, y, n, dev, num_steps, batch_size, learning_rate,
           losses):
    from mmlspark_tpu_torch.models.resnet import resnet_apply

    for i in range(num_steps):
        idx = rng.integers(0, n, size=batch_size)
        xb = torch.from_numpy(X[idx]).to(dev)
        yb = torch.from_numpy(y[idx].astype(np.int64)).to(dev)
        logits = resnet_apply(tree, xb, cut=0)
        loss = _cross_entropy(logits, yb)
        grads = torch.autograd.grad(loss, leaves)
        adam_step(leaves, grads, mu, nu, i + 1, learning_rate)
        if losses is not None:
            losses.append(float(loss.detach()))

    correct = 0
    with torch.no_grad():
        for lo in range(0, n, 256):
            xb = torch.from_numpy(X[lo: lo + 256]).to(dev)
            pred = resnet_apply(tree, xb, cut=0).argmax(dim=1).cpu().numpy()
            correct += int((pred == y[lo: lo + 256]).sum())
    return to_numpy(tree), correct / n

