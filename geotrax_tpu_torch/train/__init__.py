"""Detector training: YOLO-format data loading, fine-tuning on one card, eval.

The port of the reference's ``train/`` layer: the trainer
(``train.py``), the loss and its gradients (``models/loss.py``), Nesterov
SGD and the schedule (``optim.py``), the loader (``data.py``, with
Pillow's bicubic resize copied in ``resample.py``), mAP (``metrics.py``)
and the run log (``runlog.py``). ``python -m geotrax_tpu_torch.train``.
"""
