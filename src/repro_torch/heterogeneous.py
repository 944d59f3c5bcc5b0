"""Model-heterogeneous FedDD (paper §6.4): width-pruned VGG sub-models
federate into one full-width global model.

    PYTHONPATH=src python -m repro_torch.heterogeneous [--rounds 6] \
        [--loop] [--device D] [--num-train N] [--num-test N]

The port's twin of ``examples/heterogeneous_models.py``, printing what it
prints: the five Table 3 ("hetero-a") sub-models at their published
widths (the full model ``_vgg([64, 128, 256, 512, 512], [100, 100])``,
3.97 M fp32 parameters), client ``i`` from ``PRNGKey(10 + i)`` and the
global model from ``PRNGKey(0)``, synthetic CIFAR-10 (3000 train, 800
test samples) split Non-IID-a over the clients, lr 0.05, A_server 0.6,
h 5.  The ragged fleet runs the shape-grouped engine (one step a round
over the shape groups: coverage-aware importance per group, Eq. (4) on
the full-width canvas, Eq. (5) per group at local widths); ``--loop``
runs the per-client reference loop instead, which gives the same
results bit for bit.  Runs on ``cuda`` unless ``--device cpu`` is given;
``--num-train``/``--num-test`` cut the data (a quick CPU run).
"""

from __future__ import annotations

import argparse
from typing import Tuple

from repro_torch import prng
from repro_torch.core.protocol import FedDDServer, ProtocolConfig
from repro_torch.data import (label_coverage_score, make_dataset,
                              partition_noniid_a)
from repro_torch.device import DeviceLike
from repro_torch.fl import (HETERO_A_SPECS, init_cnn_spec, make_eval_fn,
                            make_local_train_fn, model_bytes,
                            sample_system_telemetry)

LR = 0.05
A_SERVER = 0.6
H = 5


def setup(clients: int = 5, *, num_train: int = 3000, num_test: int = 800,
          device: DeviceLike = None) -> Tuple:
    """The example's fleet: client ``i`` holds hetero-a spec ``i % 5``
    from ``PRNGKey(10 + i)``, the global model the full spec from
    ``PRNGKey(0)``; synthetic CIFAR-10 split Non-IID-a (seed 0) ->
    (global params, client params, telemetry, local_train_fn, eval_fn)."""
    specs = HETERO_A_SPECS
    train, test = make_dataset("cifar10", num_train=num_train,
                               num_test=num_test)
    parts = partition_noniid_a(train, clients, seed=0)
    client_params = [init_cnn_spec(specs[i % len(specs)], prng.PRNGKey(10 + i),
                                   device=device) for i in range(clients)]
    global_params = init_cnn_spec(specs[0], prng.PRNGKey(0), device=device)
    tel = sample_system_telemetry(
        clients, [model_bytes(p) for p in client_params],
        [len(p) for p in parts],
        [label_coverage_score(train, p) for p in parts], seed=0)
    # one trainer per spec in use (each holds the shards on the device)
    fns = [make_local_train_fn(s, train, parts, lr=LR, device=device)
           for s in specs[:clients]]

    def ltf(params, idx, key):
        return fns[idx % len(specs)](params, idx, key)

    ef = make_eval_fn(specs[0], test, device=device)
    return global_params, client_params, tel, ltf, ef


def server_for(global_params, client_params, tel, *, rounds: int = 6,
               loop: bool = False, device: DeviceLike = None,
               **cfg_kw) -> FedDDServer:
    """The example's FedDD server on the ragged fleet (``loop``: the
    per-client reference loop)."""
    cfg = ProtocolConfig(scheme="feddd", rounds=rounds, a_server=A_SERVER,
                         h=H, batched=not loop, **cfg_kw)
    return FedDDServer(global_params, cfg, tel, client_params=client_params,
                       device=device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--loop", action="store_true",
                    help="run the per-client reference loop instead of the "
                         "shape-grouped engine")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--num-train", type=int, default=3000)
    ap.add_argument("--num-test", type=int, default=800)
    args = ap.parse_args(argv)

    gp, clients, tel, ltf, ef = setup(
        num_train=args.num_train, num_test=args.num_test,
        device=args.device)
    print("client model sizes (MB):",
          [round(model_bytes(p) / 1e6, 2) for p in clients])
    server = server_for(gp, clients, tel, rounds=args.rounds,
                        loop=args.loop, device=args.device)
    executor = server.executor_kind
    what = ("per-client reference loop" if executor == "loop"
            else "one step per round over shape groups")
    print(f"heterogeneous: {server.heterogeneous}  "
          f"(executor: {executor} — {what})")
    name = next(k for k in server.cr if "conv4" in k or "conv3" in k)
    print(f"coverage of {name}: "
          f"min={server.cr[name].min():.2f} max={server.cr[name].max():.2f}")
    res = server.run(ltf, ef)
    for r in res.history:
        print(f"round {r.round}: acc={r.metrics['accuracy']:.3f} "
              f"D=[{r.dropout_rates.min():.2f},{r.dropout_rates.max():.2f}] "
              f"uploaded={r.uploaded_fraction:.0%} "
              f"host={r.host_wall_time:.2f}s", flush=True)


if __name__ == "__main__":
    main()
