# Copyright 2026. Apache License 2.0.
"""Archives for the offline prep tools, from local files only.

After ``medicalseg_tpu/utils/download.py`` (the port imports nothing of
the JAX package): :func:`_extract` unpacks a zip or tar archive as there.
The port never downloads: :func:`local_path` takes a plain path or a
``file://`` URL and raises for any other URL.
"""

import os
import tarfile
import urllib.parse
import urllib.request
import zipfile


def local_path(url):
    """The file ``url`` names on this machine: a plain path, or the path
    of a ``file://`` URL. Any other URL raises ``ValueError``."""
    parsed = urllib.parse.urlparse(url)
    if parsed.scheme == "file":
        return urllib.request.url2pathname(parsed.path)
    if parsed.scheme == "" or os.path.exists(url):
        return url
    raise ValueError(
        "{} is neither a local path nor a file:// URL, and nothing is "
        "downloaded: fetch the archive and give its path".format(url))


def _extract(archive, into, print_progress=True):
    """Extract zip/tar ``archive`` under ``into``; return the root entry
    name, or None when the file is not a recognized archive."""
    if zipfile.is_zipfile(archive):
        opener, lister, kw = zipfile.ZipFile, lambda f: f.namelist(), {}
    elif tarfile.is_tarfile(archive):
        # the "data" filter refuses members that would land outside `into`
        opener, lister = tarfile.open, lambda f: f.getnames()
        kw = {"filter": "data"}
    else:
        return None
    if print_progress:
        print("Extracting %s" % os.path.basename(archive))
    with opener(archive) as f:
        names = lister(f)
        if not names:
            raise ValueError("empty archive: %s" % archive)
        f.extractall(into, **kw)
    # the top-level entry the archive unpacks to
    return names[0].split("/")[0]
