"""TensorBoard scalar logging of the train loop (own copy of
lidarseg3d_tpu/utils/tb_logger.py), through torch.utils.tensorboard's
SummaryWriter."""


class TensorboardLogger:
    def __init__(self, log_dir):
        from torch.utils.tensorboard import SummaryWriter

        self._w = SummaryWriter(log_dir)

    def log_scalars(self, scalars, step):
        for k, v in scalars.items():
            self._w.add_scalar(k, float(v), step)

    def close(self):
        self._w.close()
