"""Ranks of tests/test_torch_port_ddp.py (run as a subprocess; imports no JAX).

Usage:
    python tests/torch_port_ddp_worker.py steps <inputs.pt> <out_dir> <port> <timeout_s>
    python tests/torch_port_ddp_worker.py cli <out_dir> <port> <timeout_s> <CLI argument> ...

Both start two CPU ranks through the port's own launcher
(``afigan_tpu_torch/engine/launch.py::launch``: spawned processes, a gloo
group at tcp://127.0.0.1:<port> whose collectives fail after <timeout_s>),
each with half this process's torch threads.

``steps``: every case named in the inputs, on each rank, written to
``<out_dir>/rank<r>.pt``:
  syncbn  a SyncBN that trains (``layers.BatchNorm2d(sync=True)``) on the
          rank's half of the batch: output, input gradient, the weight and
          bias gradients after ``mean_grads_``, running statistics;
  stage3  one ``engine/stage3.py::train_step`` from the given weights on the
          rank's two images (contiguous halves, as JAX's ``shard_batch``),
          the subsample keys fixed (``port_draws``): metrics, each trainable
          parameter's local gradient and its gradient after the reduce, the
          state dict after;
  stage1  one ``engine/stage1.py::train_step`` the same way: metrics, G's and
          D's state dicts after;
  fcos    one ``engine/stage2.py::train_step`` of the FCOS step-2 YAML the
          same way, one image a rank: metrics, the detector's and D's state
          dicts after;
  eval    ``run_inference`` of a seeded model over a tiny COCO: the
          results, the image ids this rank inferred and its own predictions;
  precise_bn  ``engine/precise_bn.py::update_bn_stats`` over the rank's
          halves of three batches through a SyncBN and a plain BN side by
          side: both running statistics and ``sync`` marks after.

``cli``: the stage-3 CLI's rank function (``stage3_train.run_rank``) on the
CLI's own parsed arguments, on each rank, with the rank's records, the ranks
that saved checkpoints and wrote ``metrics.json`` lines, and its
``data_time`` recorded to ``<out_dir>/cli_rank<r>.json``; rank 1's loader
sleeps 0.3 s a batch.
"""

import datetime
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import torch  # noqa: E402

SLOW_RANK_SLEEP = 0.3


def _cfg(yaml, overrides):
    from afigan_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(yaml)
    cfg.merge_from_list(list(overrides))
    return cfg


def _half(x, r):
    """Rank r's contiguous half of a batch's leading dimension."""
    if isinstance(x, dict):
        return {k: _half(v, r) for k, v in x.items()}
    n = x.shape[0] // 2
    return x[r * n:(r + 1) * n]


def case_syncbn(inp, r):
    from afigan_tpu_torch.models.layers import BatchNorm2d
    from afigan_tpu_torch.parallel import mean_grads_

    c = inp["weight"].shape[0]
    bn = BatchNorm2d(c, eps=inp["eps"], momentum=inp["momentum"], sync=True)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(inp["weight"]))
        bn.bias.copy_(torch.from_numpy(inp["bias"]))
    bn.train()
    x = torch.from_numpy(_half(inp["x"], r)).requires_grad_()
    y = bn(x)
    (y * torch.from_numpy(_half(inp["w"], r))).sum().backward()
    mean_grads_(bn.parameters())
    return {"y": y.detach().numpy(), "gx": x.grad.numpy(), "gw": bn.weight.grad.numpy(),
            "gb": bn.bias.grad.numpy(), "running_mean": bn.running_mean.numpy(),
            "running_var": bn.running_var.numpy()}


def case_stage3(inp, r):
    from afigan_tpu_torch.engine import stage3
    from tests.torch_port_gan_tiny import port_draws

    cfg = _cfg(inp["yaml"], inp["overrides"])
    state = stage3.init_stage3_state(cfg, device="cpu")
    state.model.load_state_dict({k: torch.from_numpy(v) for k, v in inp["before"].items()},
                                strict=True)
    local = {}
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p, n=n: local.__setitem__(n, p.grad.detach().numpy().copy()))
        for n, p in state.model.named_parameters() if p.requires_grad]
    metrics = stage3.train_step(cfg, state, stage3.batch_to_device(_half(inp["batch"], r), "cpu"),
                                draws=port_draws)
    for h in hooks:
        h.remove()
    reduced = {n: p.grad.numpy().copy() for n, p in state.model.named_parameters()
               if p.grad is not None}
    return {"metrics": metrics, "local": local, "reduced": reduced,
            "after": {k: v.numpy() for k, v in state.model.state_dict().items()}}


def case_stage1(inp, r):
    from afigan_tpu_torch.engine import stage1

    cfg = _cfg(inp["yaml"], inp["overrides"])
    state = stage1.init_stage1_state(cfg, device="cpu")
    for name in ("guide", "generator", "discriminator"):
        getattr(state, name).load_state_dict(
            {k: torch.from_numpy(v) for k, v in inp[name].items()}, strict=True)
    metrics = stage1.train_step(cfg, state, stage1.batch_to_device(_half(inp["batch"], r), "cpu"))
    return {"metrics": metrics,
            "generator": {k: v.numpy() for k, v in state.generator.state_dict().items()},
            "discriminator": {k: v.numpy()
                              for k, v in state.discriminator.state_dict().items()}}


def case_fcos(inp, r):
    from afigan_tpu_torch.engine import stage2

    cfg = _cfg(inp["yaml"], inp["overrides"])
    state = stage2.init_stage2_state(cfg, device="cpu")
    for name, module in (("det", state.model), ("guide", state.guide),
                         ("D", state.discriminator)):
        module.load_state_dict({k: torch.from_numpy(v) for k, v in inp[name].items()},
                               strict=True)
    metrics = stage2.train_step(cfg, state, stage2.batch_to_device(_half(inp["batch"], r), "cpu"))
    return {"metrics": metrics,
            "det": {k: v.numpy() for k, v in state.model.state_dict().items()},
            "D": {k: v.numpy() for k, v in state.discriminator.state_dict().items()}}


def case_eval(inp, r):
    from afigan_tpu_torch.data.coco import CocoDataset
    from afigan_tpu_torch.engine.inference import run_inference
    from afigan_tpu_torch.evaluation import CocoEvaluator
    from afigan_tpu_torch.models import build_model

    cfg = _cfg(inp["yaml"], inp["overrides"])
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(inp["seed"]))
    seen, local = [], []
    process, evaluate = CocoEvaluator.process, CocoEvaluator.evaluate

    def record(self, image_ids, *args, **kwargs):
        seen.extend(int(i) for i in image_ids)
        return process(self, image_ids, *args, **kwargs)

    def keep(self):
        local.extend(self.predictions)
        return evaluate(self)

    CocoEvaluator.process, CocoEvaluator.evaluate = record, keep
    try:
        results = run_inference(cfg, model, CocoDataset(inp["json"], inp["images"]))
    finally:
        CocoEvaluator.process, CocoEvaluator.evaluate = process, evaluate
    return {"results": results, "image_ids": seen, "predictions": local}


def case_precise_bn(inp, r):
    from afigan_tpu_torch.engine.precise_bn import update_bn_stats
    from afigan_tpu_torch.models.layers import BatchNorm2d

    c = inp["x"][0].shape[-1]
    model = torch.nn.ModuleDict({"sync": BatchNorm2d(c, momentum=0.1, sync=True),
                                 "plain": BatchNorm2d(c, momentum=0.01)}).train()

    def forward(x):
        for bn in model.values():
            bn(x)

    n = update_bn_stats(model, forward, (torch.from_numpy(_half(x, r)) for x in inp["x"]), 8)
    return {"forwards": n, "sync": [bn.sync for bn in model.values()],
            **{f"{k}_{s}": getattr(bn, f"running_{s}").numpy()
               for k, bn in model.items() for s in ("mean", "var")}}


CASES = {"syncbn": case_syncbn, "stage3": case_stage3, "stage1": case_stage1,
         "fcos": case_fcos, "eval": case_eval, "precise_bn": case_precise_bn}


def steps_rank(inputs_path, out_dir):
    from afigan_tpu_torch.parallel import rank

    inp = torch.load(inputs_path, weights_only=False)
    out = {name: CASES[name](inp[name], rank()) for name in inp["cases"]}
    torch.save(out, os.path.join(out_dir, f"rank{rank()}.pt"))


def cli_rank(args, out_dir):
    """``stage3_train.run_rank`` with its loader, checkpoints and writer
    watched: what this rank trained on and wrote."""
    from afigan_tpu_torch import stage3_train
    from afigan_tpu_torch.engine import events, trainers
    from afigan_tpu_torch.parallel import rank

    r, seen = rank(), {"image_ids": [], "saved": [], "json_lines": 0, "data_time": []}
    build_loader, save, write = (trainers.build_train_loader, trainers.save_checkpoint,
                                 events.JSONWriter.write)

    def loader(*a, **kw):  # a generator: the trainer's close() ends it and the loader
        inner = build_loader(*a, **kw)
        try:
            for batch in inner:
                seen["image_ids"].append([int(i) for i in batch["image_id"]])
                if r == 1:
                    time.sleep(SLOW_RANK_SLEEP)
                yield batch
        finally:
            inner.close()

    def saving(directory, iteration, *a, **kw):
        seen["saved"].append(iteration)
        return save(directory, iteration, *a, **kw)

    def writing(self, storage):
        seen["json_lines"] += 1
        seen["data_time"].append(storage.latest()["data_time"])
        return write(self, storage)

    trainers.build_train_loader, trainers.save_checkpoint = loader, saving
    events.JSONWriter.write = writing
    trainer = stage3_train.run_rank(args, "TargetDetectorTrainer")
    seen["parameters"] = float(sum(p.double().sum() for p in trainer.model.parameters()))
    with open(os.path.join(out_dir, f"cli_rank{r}.json"), "w") as f:
        json.dump(seen, f)


def main(argv):
    from afigan_tpu_torch.engine.launch import launch

    mode = argv[0]
    if mode == "steps":
        inputs, out_dir, port, timeout = argv[1:5]
        fn, args = steps_rank, (inputs, out_dir)
    else:
        from afigan_tpu_torch import stage3_train

        out_dir, port, timeout = argv[1:4]
        fn, args = cli_rank, (stage3_train.parse_args(argv[4:]), out_dir)
    launch(fn, 2, dist_url=f"tcp://127.0.0.1:{port}", args=args, device="cpu",
           timeout=datetime.timedelta(seconds=float(timeout)))


if __name__ == "__main__":
    main(sys.argv[1:])
