"""Backprop-through-simulation trainer for the ITSCP controller (port of
:mod:`dhts.apps.control.trainer`).

Per epoch: run ``num_episode_per_epoch`` differentiable episodes of the
controller's action (``multi_scenario``: one episode of each scenario of
the env's ``reset_batch``, each with its own observation and action),
minimise the negative mean episode reward with Adam,
evaluate every ``num_eval_epoch`` epochs in hard mode on fixed draws, append
``eval.txt`` and ``metrics.jsonl``, and checkpoint the latest and the best
controller and optimiser state (``torch.save``).

On the card a differentiable fused episode (``use_fused_episode``) runs
kernel K1's soft/straight-through forward and its backward kernel, one
launch each for all the episodes of a step (and one hard launch for an
evaluation's draws; ``packed`` trains through ``env.packed_episode_fn``,
the same single launch); with a
``mesh`` and ``mesh_fused`` the episodes of a step run through the fused
spatial step instead, and the evaluation through its hard forward: on a
one-device mesh K6's STEP body (the B episodes of the step in each launch,
T launches forward and T derivative launches per step,
:mod:`dhts_torch.ops.cuda.itscp_spatial_step`), on a ``(1, S)`` mesh K6's
per-shard bodies, one process per lane shard
(:mod:`dhts_torch.ops.cuda.itscp_spatial_shard`): every rank computes the
same loss and gradient and takes the same Adam step, and only rank 0 writes
logs and checkpoints. The controller, the action squash and Adam are
PyTorch. Randomness comes from
explicit ``torch.Generator``s: ``seed + 1`` for the training draws and
``seed + 2`` for the fixed evaluation draws, in the roles of the JAX
trainer's keys (the two give different numbers; parity tests pass the
draws in).

Not ported yet: a mesh with a data axis of more than one device, ``mesh``
without ``mesh_fused`` (the sharded scan step), ``render_eval`` and
TensorBoard logging.
"""

from __future__ import annotations

import json
import math
import os
import time

import torch

from dhts_torch.apps.control.controller import init_controller, \
    squash_action


def warmup_cosine_decay(step: int, init_value: float, peak_value: float,
                        warmup_steps: int, decay_steps: int,
                        end_value: float = 0.0) -> float:
    """``optax.warmup_cosine_decay_schedule(...)(step)``: linear warmup from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then cosine decay
    to ``end_value`` at ``decay_steps`` (which includes the warmup)."""
    cos_steps = decay_steps - warmup_steps
    if cos_steps <= 0:
        raise ValueError(f"the cosine decay needs decay_steps > warmup_steps,"
                         f" got {decay_steps} and {warmup_steps}")
    if step < warmup_steps:
        frac = 1.0 - min(max(step, 0), warmup_steps) / warmup_steps
        return (init_value - peak_value) * frac + peak_value
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    count = min(step - warmup_steps, cos_steps)
    cosine = 0.5 * (1.0 + math.cos(math.pi * count / cos_steps))
    return peak_value * ((1.0 - alpha) * cosine + alpha)


def clip_by_global_norm_(params, max_norm: float) -> float:
    """``optax.clip_by_global_norm``: scale every gradient by
    ``max_norm / norm`` unless the global norm is below ``max_norm`` (no
    epsilon, unlike ``torch.nn.utils.clip_grad_norm_``). Returns the norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    if not bool(norm < max_norm):
        for g in grads:
            g.copy_((g / norm) * max_norm)
    return float(norm)


class Trainer:

    def __init__(self, env, network_size=(256, 256), lr=1e-3, seed=0,
                 render_eval=False, multi_scenario=False, mesh=None,
                 mesh_fused=False, packed=False, lr_schedule="const",
                 schedule_epochs=None, grad_clip=None):
        """``multi_scenario``: train against the env's whole scenario batch
        (``env.reset_batch`` must have been called): the observations are
        ``env.batch_obs[B, obs]``, the controller acts per scenario and a
        step runs one episode of each scenario (``env.episode_batch``).
        ``packed`` (needs ``multi_scenario``) trains through
        ``env.packed_episode_fn``, built here from the batch of that time.

        ``lr_schedule``: ``"const"`` or ``"cosine"`` (linear warmup over
        the first ~5% of ``schedule_epochs`` updates from ``lr / 10`` to
        ``lr``, cosine decay to ``lr / 10`` after). ``grad_clip``: optional
        global-norm clip before Adam. Adam has optax's defaults: betas
        (0.9, 0.999), eps 1e-8."""
        if render_eval:
            raise NotImplementedError(
                "Trainer(render_eval) belongs to the tooling slice of the "
                "port, which is not ported yet")
        if mesh is not None and not mesh_fused:
            raise NotImplementedError(
                "Trainer(mesh without mesh_fused) runs the sharded scan step "
                "(dhts/parallel/spatial.py), which is not ported yet: "
                "ROADMAP.md queue 1, item 4")
        if mesh is not None and multi_scenario:
            raise ValueError("multi_scenario and mesh are mutually exclusive")
        if packed and not multi_scenario:
            raise ValueError("packed=True rides the scenario batch: pass "
                             "multi_scenario=True")
        if multi_scenario and getattr(env, "batch_obs", None) is None:
            raise ValueError("call env.reset_batch(B) before "
                             "Trainer(multi_scenario=True)")
        if lr_schedule not in ("const", "cosine"):
            raise ValueError(f"unknown lr_schedule {lr_schedule!r}")
        self.env = env
        self.device = env.device
        self.multi_scenario = bool(multi_scenario)
        self.obs = torch.as_tensor(
            env.batch_obs if multi_scenario else env.observe(),
            device=self.device)
        self.low, self.high = env.action_bounds()
        self.model = init_controller(
            torch.Generator().manual_seed(seed), self.obs.shape[-1],
            env.action_size(), network_size, device=self.device)
        self.lr = float(lr)
        self.lr_schedule = lr_schedule
        self.schedule_epochs = int(schedule_epochs or 100)
        self.grad_clip = float(grad_clip) if grad_clip else None
        self.opt = torch.optim.Adam(self.model.parameters(), lr=self.lr,
                                    betas=(0.9, 0.999), eps=1e-8)
        self.step_count = 0
        self.seed = int(seed)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.seed + 1)
        self.best_eval_reward = -float("inf")
        self.grad_norm = None  # before clipping, when grad_clip is set
        # only one process of a sharded mesh writes logs and checkpoints
        self.writer = mesh is None or mesh.writer
        self._spatial_step = self._spatial_eval = None
        self._packed = env.packed_episode_fn() if packed else None
        if mesh is not None:
            from dhts_torch.ops.cuda import itscp_spatial_step as k6

            self._spatial_step = k6.make_fused_spatial_train_step_2d(
                env, self.model, self.apply_update, mesh, self.obs,
                self.low, self.high)
            self._spatial_eval = k6.make_fused_spatial_episode(
                env, mesh, differentiable=False)

    # -- one update ----------------------------------------------------------

    def learning_rate(self, step: int) -> float:
        if self.lr_schedule == "const":
            return self.lr
        total = self.schedule_epochs
        return warmup_cosine_decay(step, self.lr / 10.0, self.lr,
                                   max(1, total // 20), total,
                                   self.lr / 10.0)

    def action(self):
        """The controller's squashed action for the env's observation
        (``[B, n_act]`` for the B scenarios with ``multi_scenario``)."""
        return squash_action(self.model(self.obs), self.low, self.high)

    def apply_update(self, loss):
        """Backpropagate ``loss`` and take one Adam step (after the
        optional global-norm clip, at the scheduled learning rate)."""
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        if self.grad_clip:
            self.grad_norm = clip_by_global_norm_(self.model.parameters(),
                                                  self.grad_clip)
        for group in self.opt.param_groups:
            group["lr"] = self.learning_rate(self.step_count)
        self.opt.step()
        self.step_count += 1

    def train_step(self, num_episode: int = 1, rand=None) -> float:
        """One Adam update on the mean soft reward of ``num_episode``
        episodes; ``rand`` (``[E, T, L]``) replaces the generator's draws.
        Returns the loss. With ``use_fused_episode`` the E episodes share
        the action and run as one launch of K1's forward and one of its
        backward. With ``multi_scenario`` a step runs one episode of each
        of the B scenarios (``num_episode`` is not read; ``rand`` is
        ``[B, T, L]``). With a mesh, the fused spatial train step
        (``make_fused_spatial_train_step_2d``) runs the E episodes."""
        if rand is None:
            n = self.obs.shape[0] if self.multi_scenario else num_episode
            rand = torch.stack([self.env.draw_rand(self.generator)
                                for _ in range(max(1, n))])
        if self._spatial_step is not None:
            return self._spatial_step(rand)
        action = self.action()
        if self._packed is not None:
            rewards = self._packed(action, rand).reward
        elif self.multi_scenario:
            rewards = self.env.episode_batch(action, True, rand).reward
        elif self.env.config.get("use_fused_episode"):
            rewards = self.env._fused_episode_one(True)(
                action, self.env.data, rand).reward
        else:
            rewards = torch.stack([
                self.env.episode(action, True, rand=r).reward for r in rand])
        loss = -torch.mean(rewards)
        self.apply_update(loss)
        return float(loss.detach())

    # -- training loop -------------------------------------------------------

    def train(self, num_episode_per_epoch: int, num_epoch: int,
              num_eval_epoch: int, num_eval_episode: int, log_path: str,
              verbose: bool = True, initial_best: float = -float("inf"),
              epoch_offset: int = 0):
        """``initial_best``/``epoch_offset`` carry the best-checkpoint bar
        and the epoch count across staged runs sharing one ``log_path``."""
        if self.writer:
            os.makedirs(log_path, exist_ok=True)
        metrics_path = os.path.join(log_path, "metrics.jsonl")
        self.best_eval_reward = initial_best
        history = []
        for _epoch in range(num_epoch):
            epoch = _epoch + epoch_offset
            if epoch % max(1, num_eval_epoch) == 0:
                self.evaluate(epoch, num_eval_episode, log_path, verbose)
            loss = self.train_step(max(1, num_episode_per_epoch))
            history.append(loss)
            if not self.writer:
                continue
            with open(metrics_path, "a") as f:
                f.write(json.dumps({"epoch": epoch, "loss_train": loss,
                                    "t": time.time()}) + "\n")
            if verbose:
                print(f"epoch {epoch}: loss {loss:.6f}")
            self.save(os.path.join(log_path, "model.pt"))
        return history

    def eval_rand(self, num_episode: int):
        """The fixed evaluation draws: the same ``num_episode`` tensors at
        every evaluation, from a generator seeded with ``seed + 2``
        (``[T, L]`` each; ``[B, T, L]`` with ``multi_scenario``, one draw
        per scenario)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed + 2)
        draws = [self.env.draw_rand(gen) for _ in range(
            max(1, num_episode) * (self.obs.shape[0] if self.multi_scenario
                                   else 1))]
        if not self.multi_scenario:
            return draws
        B = self.obs.shape[0]
        return [torch.stack(draws[i:i + B]) for i in range(0, len(draws), B)]

    def _eval_rewards(self, action, draws) -> list:
        """Hard-mode rewards of the evaluation draws (with
        ``multi_scenario`` each the mean over the B scenarios of one
        batched episode)."""
        env = self.env
        if self._spatial_eval is not None:
            return [float(self._spatial_eval(action, rand=r).reward)
                    for r in draws]
        if self.multi_scenario:
            return [float(env.episode_batch(action, False, r).reward.mean())
                    for r in draws]
        if env.config.get("use_fused_episode"):
            res = env._fused_episode_one(False)(action, env.data,
                                                torch.stack(draws))
            return [float(r) for r in res.reward]
        return [float(env.episode(action, False, rand=r).reward)
                for r in draws]

    def evaluate(self, epoch, num_episode, log_path, verbose=True):
        """Mean hard-mode reward over the fixed draws (on the fused path one
        launch for all of them); appends ``eval.txt`` and ``metrics.jsonl``
        and saves ``best/model.pt`` on a new best."""
        with torch.no_grad():
            rewards = self._eval_rewards(self.action(),
                                         self.eval_rand(num_episode))
        avg = sum(rewards) / len(rewards)
        if not self.writer:
            self.best_eval_reward = max(self.best_eval_reward, avg)
            return avg
        os.makedirs(log_path, exist_ok=True)
        with open(os.path.join(log_path, "eval.txt"), "a") as f:
            f.write(f"{-avg:08f}\n")
        with open(os.path.join(log_path, "metrics.jsonl"), "a") as f:
            f.write(json.dumps({"epoch": epoch, "reward_eval": avg,
                                "t": time.time()}) + "\n")
        if verbose:
            print(f"  eval @ epoch {epoch}: reward {avg:.4f}")
        if avg > self.best_eval_reward:
            self.best_eval_reward = avg
            os.makedirs(os.path.join(log_path, "best"), exist_ok=True)
            self.save(os.path.join(log_path, "best", "model.pt"))
        return avg

    # -- checkpointing -------------------------------------------------------

    def save(self, path: str):
        torch.save({"params": self.model.state_dict(),
                    "opt_state": self.opt.state_dict(),
                    "step": self.step_count}, path)

    def load(self, path: str):
        blob = torch.load(path, map_location=self.device)
        self.model.load_state_dict(blob["params"])
        self.opt.load_state_dict(blob["opt_state"])
        self.step_count = int(blob.get("step", 0))
