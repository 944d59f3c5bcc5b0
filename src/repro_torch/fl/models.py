"""The paper's FL models (Tables 2, 3, 6) as plain functions on tensors.

  MLP   FC(784,100)-ReLU-FC(100,64)-ReLU-FC(64,10)           (MNIST)
  CNN1  Conv(1,10,5)-pool-Conv(10,20,5)-pool-FC(320,50)-FC(50,10)   (FMNIST)
  CNN2  3xConv(16/32/64,k3)+pool-FC(1024,500)-FC(500,100)-FC(100,10) (CIFAR10)

plus the five width-pruned VGG-style sub-models of Tables 3 (hetero-a)
and 6 (hetero-b), the model-heterogeneous fleets of the paper's §6.4.

Parameters are dicts of tensors in the JAX package's layout — dense
``(in, out)``, conv ``HWIO``, images NHWC — so FedDD's channel masks
(channel_axis=-1) apply unchanged and both packages compare leaf for
leaf; convolutions run in NCHW inside :func:`apply_spec`, through
``kernels.conv.ops.conv2d_same``: ``F.conv2d`` outside ``torch.func``
transforms, and under ``torch.func.vmap`` of a client step on the card
(weights with a client dimension) the client-batched kernels.

float32 stays float32 on the card, and a run repeats bit for bit:
:func:`make_local_train_fn` and :func:`make_eval_fn` switch off TF32 for
matmuls and cuDNN convolutions (``torch.backends.cuda.matmul.allow_tf32``
/ ``torch.backends.cudnn.allow_tf32``) and ask cuDNN for its
deterministic convolution algorithms (``torch.backends.cudnn
.deterministic``), process-wide.  Without the last, the backward passes
of a VGG's convolutions may sum in another order each run, and no run of
a conv model could be held to another (``scripts/conv_determinism.py``
measures the drift between two equal runs on the card).  The
client-batched kernels sum in a fixed order of their own.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import prng, tree
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.conv.ops import conv2d_same

# A spec is a list of layer tuples:
#   ("conv", in_ch, out_ch, kernel)    SAME conv + ReLU
#   ("pool",)                          2x2 max pool
#   ("fc", d_in, d_out)                dense (+ReLU except last)
MLP_SPEC = [("fc", 784, 100), ("fc", 100, 64), ("fc", 64, 10)]
CNN1_SPEC = [("conv", 1, 10, 5), ("pool",), ("conv", 10, 20, 5), ("pool",),
             ("fc", 320, 50), ("fc", 50, 10)]
CNN2_SPEC = [("conv", 3, 16, 3), ("pool",), ("conv", 16, 32, 3), ("pool",),
             ("conv", 32, 64, 3), ("pool",),
             ("fc", 1024, 500), ("fc", 500, 100), ("fc", 100, 10)]


def _vgg(widths: Sequence[int], fcs: Sequence[int]) -> List[Tuple]:
    """3x3 conv + pool per width (32x32 through 5 pools -> 1x1), then the
    fc layers ``fcs`` and a 10-way head."""
    spec: List[Tuple] = []
    cin = 3
    for w in widths:
        spec += [("conv", cin, w, 3), ("pool",)]
        cin = w
    dims = [widths[-1]] + list(fcs) + [10]
    for i in range(len(dims) - 1):
        spec.append(("fc", dims[i], dims[i + 1]))
    return spec


# Table 3 (model-heterogeneous-a): five VGG-ish sub-models
HETERO_A_SPECS = [
    _vgg([64, 128, 256, 512, 512], [100, 100]),   # full model
    _vgg([64, 128, 256, 256, 512], [100, 100]),
    _vgg([64, 128, 256, 256, 512], [80, 100]),
    _vgg([32, 128, 256, 256, 512], [80, 100]),
    _vgg([32, 128, 128, 256, 512], [80, 100]),
]

# Table 6 (model-heterogeneous-b): larger spread
HETERO_B_SPECS = [
    _vgg([64, 128, 256, 512, 512], [100, 100]),   # full model
    _vgg([64, 128, 256, 256, 256], [100, 100]),
    _vgg([64, 128, 256, 256, 256], [80, 80]),
    _vgg([32, 96, 256, 256, 256], [80, 80]),
    _vgg([32, 96, 128, 128, 256], [80, 80]),
]


def _full_fp32() -> None:
    """float32 matmuls and convolutions in full float32 (no TF32), and
    cuDNN's deterministic convolution algorithms."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True


def init_cnn_spec(spec: Sequence[Tuple], key=None, *, seed: int = 0,
                  device: DeviceLike = None) -> Dict:
    """The JAX package's ``init_cnn_spec(key, spec)``: per layer, split
    the key and scale ``normal(sub, shape)`` by 1/sqrt(fan-in); zero
    biases.  ``key`` defaults to ``PRNGKey(seed)``.  The normals agree
    with ``jax.random.normal`` within a few float32 ulps
    (:func:`repro_torch.prng.normal`); carry the JAX package's numbers
    over with :mod:`repro_torch.convert` where a run must match bit for
    bit."""
    dev = resolve_device(device)
    key = prng.PRNGKey(seed) if key is None else prng.as_key(key)
    params: Dict[str, Dict] = {}
    for li, layer in enumerate(l for l in spec if l[0] != "pool"):
        key, sub = prng.split(key)
        if layer[0] == "conv":
            _, cin, cout, k = layer
            w = (prng.normal(sub, (k, k, cin, cout), dev)
                 * (1.0 / math.sqrt(cin * k * k)))
            params[f"conv{li}"] = {"w": w, "b": torch.zeros(cout,
                                                            device=dev)}
        else:
            _, din, dout = layer
            # a tensor divisor: CUDA divides by a Python scalar through
            # its reciprocal, one ulp away from the true quotient
            w = prng.normal(sub, (din, dout), dev) / torch.tensor(
                math.sqrt(din), dtype=torch.float32, device=dev)
            params[f"fc{li}"] = {"w": w, "b": torch.zeros(dout, device=dev)}
    return params


def init_mlp(key=None, *, seed: int = 0, device: DeviceLike = None) -> Dict:
    return init_cnn_spec(MLP_SPEC, key, seed=seed, device=device)


def init_cnn(which: str, key=None, *, seed: int = 0,
             device: DeviceLike = None) -> Dict:
    """CNN1 (``which == "cnn1"``) or CNN2 (anything else), as the JAX
    package's ``init_cnn``."""
    return init_cnn_spec(CNN1_SPEC if which == "cnn1" else CNN2_SPEC, key,
                         seed=seed, device=device)


def apply_spec(params: Dict, spec: Sequence[Tuple],
               x: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, C) images or (B, D) flats for pure-MLP specs."""
    li = 0
    n_fc_seen = 0
    n_fc = sum(1 for l in spec if l[0] == "fc")
    nchw = False
    for layer in spec:
        if layer[0] == "conv":
            if not nchw:
                x = x.permute(0, 3, 1, 2)
                nchw = True
            p = params[f"conv{li}"]
            x = conv2d_same(x, p["w"].permute(3, 2, 0, 1))
            x = F.relu(x + p["b"].view(1, -1, 1, 1))
            li += 1
        elif layer[0] == "pool":
            x = F.max_pool2d(x, 2, 2)
        elif layer[0] == "fc":
            if x.ndim > 2:
                if nchw:    # flatten in the JAX package's NHWC order
                    x = x.permute(0, 2, 3, 1)
                    nchw = False
                x = x.reshape(x.shape[0], -1)
            p = params[f"fc{li}"]
            x = x @ p["w"] + p["b"]
            n_fc_seen += 1
            if n_fc_seen < n_fc:
                x = F.relu(x)
            li += 1
    return x


def model_bytes(params) -> int:
    return int(sum(l.numel() * l.element_size() for l in tree.leaves(params)))


# ------------------------------------------------------- train / eval ------

def _ce(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, y[:, None])[:, 0]
    return (logz - gold).mean()


def make_local_train_fn(spec: Sequence[Tuple], ds, parts,
                        *, lr: float = 0.05, batch_size: int = 64,
                        local_epochs: int = 1, flatten: bool = False,
                        device: DeviceLike = None):
    """Returns local_train_fn(params, client_idx, key) -> (params, loss):
    ``local_epochs`` epochs of minibatch SGD on the client's shard, epoch
    ``e`` in the order ``prng.permutation(fold_in(key, e), n)`` — the JAX
    package's shuffle, drawn on the host and copied to the device once
    an epoch.  Client shards move to the device once, here.  The loss is
    the mean minibatch loss as a Python float: the per-step losses summed
    in float64 on the device (the order of the JAX package's Python sum)
    and divided on the host, as the JAX package divides."""
    dev = resolve_device(device)
    _full_fp32()
    xs = [torch.from_numpy(ds.x[p]).to(dev) for p in parts]
    ys = [torch.from_numpy(ds.y[p].astype(np.int64)).to(dev) for p in parts]
    if flatten:
        xs = [x.reshape(x.shape[0], -1) for x in xs]

    def step(params, xb, yb):
        leaves, treedef = tree.flatten(params)
        leaves = [l.detach().requires_grad_(True) for l in leaves]
        loss = _ce(apply_spec(tree.unflatten(treedef, leaves), spec, xb), yb)
        grads = torch.autograd.grad(loss, leaves)
        new = [(l - lr * g).detach() for l, g in zip(leaves, grads)]
        return tree.unflatten(treedef, new), loss.detach()

    def local_train(params, client_idx: int, key):
        x, y = xs[client_idx], ys[client_idx]
        n = x.shape[0]
        if n == 0:
            return params, 0.0
        loss = torch.zeros((), dtype=torch.float64, device=dev)
        steps = 0
        for ep in range(local_epochs):
            perm = prng.permutation(prng.fold_in(key, ep), n,
                                    "cpu").to(dev)
            for s in range(0, max(n - batch_size + 1, 1), batch_size):
                idx = perm[s:s + batch_size]
                params, l = step(params, x[idx], y[idx])
                loss = loss + l.double()
                steps += 1
        return params, float(loss) / max(steps, 1)

    return local_train


def make_eval_fn(spec: Sequence[Tuple], test_ds, *, flatten: bool = False,
                 batch_size: int = 512, per_class: bool = False,
                 device: DeviceLike = None):
    """Returns eval_fn(params) -> {"accuracy": float}; with ``per_class``
    also ``acc_class_<c>`` for each of the test set's classes (0.0 for a
    class with no test sample), the rare-class view of the paper's
    generalisation claim."""
    dev = resolve_device(device)
    _full_fp32()
    x = torch.from_numpy(test_ds.x).to(dev)
    y = np.asarray(test_ds.y)
    if flatten:
        x = x.reshape(x.shape[0], -1)

    def eval_fn(params) -> Dict:
        with torch.no_grad():
            pred = torch.cat([
                apply_spec(params, spec, x[s:s + batch_size]).argmax(-1)
                for s in range(0, x.shape[0], batch_size)]).cpu().numpy()
        out = {"accuracy": float(np.mean(pred == y))}
        if per_class:
            for c in range(test_ds.num_classes):
                m = y == c
                out[f"acc_class_{c}"] = (float(np.mean(pred[m] == y[m]))
                                         if m.any() else 0.0)
        return out

    return eval_fn
