# Copyright 2026. Apache License 2.0.
"""Loss dispatcher pairing the model's logits list with the loss config.
Counterpart of ``medicalseg_tpu/utils/loss_utils.py``, with the same
per-type special cases (BCE/Focal edge labels, MixedLoss and DiceLoss
tuples, the KL logit-pair hook)."""


def check_logits_losses(logits_list, losses):
    len_logits = len(logits_list)
    len_losses = len(losses["types"])
    if len_logits != len_losses:
        raise RuntimeError(
            "The length of logits_list should equal to the types of loss "
            "config: {} != {}.".format(len_logits, len_losses))


def loss_computation(logits_list, labels, losses, edges=None):
    """Returns (loss_list, per_channel_dice).

    ``losses`` is the config dict {'types': [loss objects], 'coef': [...]}.
    """
    check_logits_losses(logits_list, losses)
    loss_list = []
    per_channel_dice = None
    for i, logits in enumerate(logits_list):
        loss_i = losses["types"][i]
        coef_i = losses["coef"][i]
        name = type(loss_i).__name__
        if name in ("BCELoss", "FocalLoss") and getattr(
                loss_i, "edge_label", False):
            loss_list.append(coef_i * loss_i(logits, edges))
        elif name == "MixedLoss":
            mixed_loss_list, per_channel_dice = loss_i(logits, labels)
            for mixed_loss in mixed_loss_list:
                loss_list.append(coef_i * mixed_loss)
        elif name == "KLLoss":
            loss_list.append(coef_i * loss_i(logits_list[0],
                                             logits_list[1].detach()))
        elif name == "DiceLoss":
            loss, per_channel_dice = loss_i(logits, labels)
            loss_list.append(coef_i * loss)
        else:
            loss_list.append(coef_i * loss_i(logits, labels))
    return loss_list, per_channel_dice
