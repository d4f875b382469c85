# Copyright 2026. Apache License 2.0.
"""Archive extraction for the offline prep tools (after
``tools/preprocess_utils/uncompress.py``, without its download: the port
reads archives from local paths only)."""

import os

from ...utils.download import _extract


class uncompressor:
    """API-parity wrapper: ``._uncompress_file(filepath, extrapath,
    delete_file, print_progress)`` extracts a zip or tar archive."""

    @staticmethod
    def _uncompress_file(filepath, extrapath, delete_file=False,
                         print_progress=True):
        root = _extract(filepath, extrapath, print_progress)
        if delete_file and os.path.exists(filepath):
            os.remove(filepath)
        return root
