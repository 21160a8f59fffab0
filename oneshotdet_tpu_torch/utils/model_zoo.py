"""Model-zoo weights: ``catalog://`` names and the URL download cache
(counterpart of ``oneshotdet_tpu/utils/model_zoo.py``).

``resolve_weight_path`` turns ``catalog://Name`` into its URL
(``data.paths_catalog.ModelCatalog``, or the ``ModelCatalog`` of the python
file ``cfg.PATHS_CATALOG`` names) and a ``http(s)://`` or ``file://`` URL
into a file of the local cache; a plain path passes through. The transfer
is stdlib ``urllib``, so ``file://`` URLs work offline.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import re
import sys
import urllib.parse
import urllib.request

from .comm import is_main_process, synchronize

# torch.hub's convention: filename-<sha256 prefix>.ext
HASH_REGEX = re.compile(r"-([a-f0-9]*)\.")


def default_cache_dir() -> str:
    """``ONESHOT_MODEL_ZOO``, else ``$ONESHOT_HOME/models`` (default
    ``~/.oneshotdet_tpu/models``)."""
    home = os.path.expanduser(os.getenv("ONESHOT_HOME", "~/.oneshotdet_tpu"))
    return os.getenv("ONESHOT_MODEL_ZOO", os.path.join(home, "models"))


def cache_url(url: str, model_dir: str | None = None) -> str:
    """The cached copy of ``url``, fetched once. The URL's fragment, when
    present, names the file, else its last path component; Detectron's
    ``model_final.pkl`` files are named by their whole path (slashes ->
    underscores). A name ``stem-<hex>.ext`` with 6 or more hex digits is
    checked against the file's sha256. Only the main process fetches."""
    if model_dir is None:
        model_dir = default_cache_dir()
    os.makedirs(model_dir, exist_ok=True)
    parts = urllib.parse.urlparse(url)
    filename = parts.fragment or os.path.basename(parts.path)
    if filename == "model_final.pkl":
        filename = parts.path.replace("/", "_")
    cached_file = os.path.join(model_dir, filename)
    if not os.path.exists(cached_file) and is_main_process():
        sys.stderr.write(f'Downloading: "{url}" to {cached_file}\n')
        tmp = cached_file + ".part"
        urllib.request.urlretrieve(url, tmp)
        hash_prefix = HASH_REGEX.search(filename)
        # Caffe2 file names carry no real hash: check only prefixes long enough to be one
        if hash_prefix is not None and len(hash_prefix.group(1)) >= 6:
            prefix = hash_prefix.group(1)
            digest = hashlib.sha256()
            with open(tmp, "rb") as f:
                for chunk in iter(lambda: f.read(1 << 20), b""):
                    digest.update(chunk)
            if not digest.hexdigest().startswith(prefix):
                os.remove(tmp)
                raise RuntimeError(f"invalid hash value for {url}: expected prefix {prefix}, "
                                   f"got {digest.hexdigest()}")
        os.replace(tmp, cached_file)
    synchronize()
    return cached_file


def resolve_weight_path(f: str, cfg=None, logger=None) -> str:
    """catalog:// -> URL -> cached local file; a local path as it is."""
    log = logger.info if logger else print
    if f.startswith("catalog://"):
        resolved = _model_catalog(cfg).get(f[len("catalog://"):])
        log(f"{f} points to {resolved}")
        f = resolved
    if f.startswith(("http://", "https://", "file://")):
        cached = cache_url(f)
        log(f"url {f} cached in {cached}")
        f = cached
    return f


def _model_catalog(cfg):
    path = getattr(cfg, "PATHS_CATALOG", "") if cfg is not None else ""
    if path:
        spec = importlib.util.spec_from_file_location("oneshotdet_tpu_torch._user_paths_catalog",
                                                      path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.ModelCatalog
    from ..data.paths_catalog import ModelCatalog

    return ModelCatalog
