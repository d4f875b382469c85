# Copyright 2026. Apache License 2.0.
"""The framework's home directories.

Counterpart of ``medicalseg_tpu/utils/env.py`` (reference
medicalseg/utils/env_util/seg_env.py:28-56), rooted at
``~/.medicalseg_torch`` or at ``$SEG_HOME`` where that names an existing
directory. ``USER_HOME``, ``SEG_HOME``, ``DATA_HOME``, ``TMP_HOME`` and
``PRETRAINED_MODEL_HOME`` are read at each access, so they follow
``$SEG_HOME``; a sub-home (``dataset``, ``tmp``, ``pretrained_model``) is
created when it is first read, never when the module is imported. Nothing
downloads into them: the port takes local files only. ``get_sys_env`` is
in :mod:`medicalseg_torch.utils.utils`.
"""

import os

_SUB_HOMES = {"DATA_HOME": "dataset", "TMP_HOME": "tmp",
              "PRETRAINED_MODEL_HOME": "pretrained_model"}
__all__ = ["USER_HOME", "SEG_HOME", *_SUB_HOMES]


def _get_user_home():
    return os.path.expanduser("~")


def _get_seg_home():
    home = os.environ.get("SEG_HOME")
    if home and os.path.isdir(home):
        return home
    return os.path.join(_get_user_home(), ".medicalseg_torch")


def _get_sub_home(directory):
    home = os.path.join(_get_seg_home(), directory)
    os.makedirs(home, exist_ok=True)
    return home


def __getattr__(name):
    if name == "USER_HOME":
        return _get_user_home()
    if name == "SEG_HOME":
        return _get_seg_home()
    if name in _SUB_HOMES:
        return _get_sub_home(_SUB_HOMES[name])
    raise AttributeError("module {!r} has no attribute {!r}".format(
        __name__, name))
