"""Run logger: tensorboard / wandb / formatted stdout multiplexer.

Counterpart of ``partmanip_tpu/utils/logger.py``, owning the ckpt/pose/video
directory layout and the group/id naming convention (group
``{task}_{algo}``, id ``{exp}_seed{seed}``)."""

from __future__ import annotations

import os
from os.path import join as pjoin


class Logger:
    def __init__(self, cfg: dict, exp_name: str, task_name: str,
                 algo_name: str):
        cfg_log = cfg["log"]
        self.max_iterations = cfg["algo"]["max_iterations"]
        self.wandb_flag = False
        self.tb_flag = False
        self.screen_flag = False

        group = cfg_log.get("group") or f"{task_name}_{algo_name}"
        run_id = cfg_log.get("id") or exp_name
        root = cfg_log["log_root"]
        self.save_ckpt_dir = pjoin(root, "ckpts", group, run_id)
        self.save_pose_dir = pjoin(root, "scene_pose", group, run_id)
        self.save_video_dir = pjoin(root, "video", group, run_id)

        mode = cfg_log.get("mode", ["screen"])
        if "wandb" in mode:
            try:
                import wandb
                wandb.init(dir=root, project=cfg_log["wandb"]["project"],
                           entity=cfg_log["wandb"].get("entity"),
                           group=group, id=run_id, config=cfg,
                           resume="allow" if cfg.get("resume") else None)
                self.wandb_flag = True
            except ImportError:
                print("wandb not available; logging to tensorboard instead")
                mode = list(mode) + ["tensorboard"]
        if "tensorboard" in mode and not self.wandb_flag:
            try:
                from torch.utils.tensorboard import SummaryWriter
                tb_dir = pjoin(root, "tensorboard", group, run_id)
                self.writer = SummaryWriter(log_dir=tb_dir)
                self.tb_flag = True
                print(f"tensorboard logs → {tb_dir}")
            except ImportError:
                print("tensorboard not available")
        if "screen" in mode:
            self.pad = 35
            self.width = 80
            self.screen_flag = True

    def info(self, record: dict, iteration: int):
        if self.wandb_flag:
            import wandb
            wandb.log(data=record, step=iteration)
        if self.tb_flag:
            for k, v in record.items():
                self.writer.add_scalar(k, v, iteration)
        if self.screen_flag:
            out = "#" * self.width + "\n"
            out += (f" Learning iteration {iteration}/{self.max_iterations} "
                    .center(self.width, " ") + "\n\n")
            for k, v in record.items():
                out += f"{k:<{self.pad}}: {float(v):.6f}\n"
            print(out)

    def update_resume_path(self, resume_path: str) -> str:
        """Resolve a ckpt path relative to the ckpt root."""
        if os.path.exists(resume_path):
            return resume_path
        return pjoin(os.path.dirname(self.save_ckpt_dir), resume_path)
