"""Dataset acquisition: a framework-free copy of the CIFAR-10 part of
``tpunet/data/download.py``.

The reference auto-downloads CIFAR-10 through torchvision
(cifar10_mpi_mobilenet_224.py:93-102, ``download=True`` at :97). This
module is the tpunet equivalent: a checksum-verified HTTP fetch, invoked
lazily by the data layer. The multi-host gate (rank 0 fetches, the
others wait) is the train CLI's (``tpunet_torch/train/__main__.py``).
What remains is ROADMAP item 2b's download: CIFAR-10 and the
ImageNet-pretrained weights (``pretrained_path="auto"``).

In a no-egress environment the fetch fails fast with the exact drop-in
procedure (file name, destination, checksum), so a user can stage the
artifacts out-of-band and rerun — nothing else in the stack changes.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
import urllib.error
import urllib.request

# Canonical CIFAR-10 python tarball (the file torchvision's download
# produces and pins by md5).
CIFAR10_URL = "https://www.cs.toronto.edu/~kriz/cifar-10-python.tar.gz"
CIFAR10_MD5 = "c58f30108f718f92721af3b95e74349a"

# Extracted/tarball names of the standard CIFAR-10 python layout —
# shared with tpunet_torch/data/cifar10.py (single source of truth).
BATCH_DIR = "cifar-10-batches-py"
TARBALL = "cifar-10-python.tar.gz"


class DownloadError(RuntimeError):
    """Fetch failed (no egress / checksum mismatch); carries drop-in help."""


def _checksums(path: str):
    md5, sha = hashlib.md5(), hashlib.sha256()
    with open(path, "rb") as f:
        while chunk := f.read(1 << 20):
            md5.update(chunk)
            sha.update(chunk)
    return md5.hexdigest(), sha.hexdigest()


def fetch(url: str, dest: str, *, md5: str | None = None,
          sha256_prefix: str | None = None, timeout: float = 60.0) -> str:
    """Download ``url`` to ``dest`` atomically (tempfile + rename) and
    verify checksums. Returns ``dest``. Raises :class:`DownloadError` on
    network failure or checksum mismatch (partial/corrupt files are
    removed, never left at ``dest``)."""
    os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
    fd, part = tempfile.mkstemp(dir=os.path.dirname(dest) or ".",
                                suffix=".part")
    try:
        with os.fdopen(fd, "wb") as out:
            with urllib.request.urlopen(url, timeout=timeout) as r:
                while chunk := r.read(1 << 20):
                    out.write(chunk)
        got_md5, got_sha = _checksums(part)
        if md5 and got_md5 != md5:
            raise DownloadError(f"{url}: md5 {got_md5} != expected {md5}")
        if sha256_prefix and not got_sha.startswith(sha256_prefix):
            raise DownloadError(f"{url}: sha256 {got_sha[:8]}... != "
                                f"expected prefix {sha256_prefix}")
        os.replace(part, dest)
        return dest
    except (urllib.error.URLError, OSError, TimeoutError) as e:
        raise DownloadError(f"fetching {url} failed: {e}") from e
    finally:
        if os.path.exists(part):
            os.unlink(part)


def ensure_cifar10(data_dir: str, download: bool = True) -> str:
    """Make sure the CIFAR-10 tarball (or extracted batches) exists under
    ``data_dir``, downloading it when permitted. Returns ``data_dir``.

    Mirrors the reference's ``download=True`` dataset construction
    (cifar10_mpi_mobilenet_224.py:93-102).
    """
    data_dir = os.path.expanduser(data_dir)
    tarball = os.path.join(data_dir, TARBALL)
    if os.path.isdir(os.path.join(data_dir, BATCH_DIR)):
        return data_dir
    if os.path.exists(tarball):
        # Verify staged (drop-in) tarballs too — torchvision's
        # check_integrity does the same for pre-existing files; a
        # truncated copy would otherwise die later in tarfile/pickle
        # with no actionable message.
        got_md5, _ = _checksums(tarball)
        if got_md5 != CIFAR10_MD5:
            raise DownloadError(
                f"{tarball!r} is corrupt (md5 {got_md5} != expected "
                f"{CIFAR10_MD5}); delete it and re-stage "
                f"cifar-10-python.tar.gz from {CIFAR10_URL}")
        return data_dir
    help_text = (
        f"CIFAR-10 is not present under {data_dir!r}. "
        f"Drop-in procedure for offline environments: obtain "
        f"{TARBALL} (md5 {CIFAR10_MD5}) from "
        f"{CIFAR10_URL} and place it at {tarball!r}; it is extracted "
        f"automatically on the next run. Or use --dataset synthetic.")
    if not download:
        raise DownloadError("downloads disabled (--no-download). " + help_text)
    try:
        print(f"Downloading CIFAR-10 -> {tarball}")
        fetch(CIFAR10_URL, tarball, md5=CIFAR10_MD5)
    except DownloadError as e:
        raise DownloadError(f"{e}. {help_text}") from e
    return data_dir
