"""Training: the masked multi-stage loss, Chainer's Adam with the stem
scale and freeze, the eager train step and checkpoints (port of
``tpupose/train``)."""

from tpupose_torch.train.loss import compute_loss, compute_loss_single
from tpupose_torch.train.optimizer import (
    FREEZE_LAYERS,
    GRAD_SCALE_LAYERS,
    ChainerAdam,
    make_lr_schedule,
    make_optimizer,
)
from tpupose_torch.train.trainer import (
    TrainBatch,
    TrainState,
    init_train_state,
    make_eval_step,
    make_train_step,
    pad_poses,
    preprocess_imgs,
)
