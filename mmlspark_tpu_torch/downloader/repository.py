"""Model repository + downloader.

Reference: ``downloader/ModelDownloader.scala:210`` (``Repository``
abstraction with ``HDFSRepo:55`` and ``DefaultModelRepo:125`` over the CDN),
``downloader/Schema.scala`` (``ModelSchema`` JSON: name, uri, hash,
inputNode, layerNames), and ``FaultToleranceUtils.retryWithTimeout``
(``ModelDownloader.scala:37-52``).

The port's copy of ``mmlspark_tpu/downloader/repository.py``: models are
parameter payloads (:mod:`mmlspark_tpu_torch.models.zoo`) consumed by
:mod:`mmlspark_tpu_torch.dnn`; the local filesystem repo is primary, the
remote repo keeps the reference's retry semantics for deployments with
network access. Hashes, the JSON layout and the errors are the reference's,
so either package reads the other's repository.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from dataclasses import asdict, dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, TypeVar

T = TypeVar("T")


@dataclass
class ModelSchema:
    """Model metadata (``downloader/Schema.scala``)."""

    name: str
    uri: str
    hash: Optional[str] = None
    size: Optional[int] = None
    inputNode: Optional[str] = None
    numLayers: Optional[int] = None
    layerNames: List[str] = field(default_factory=list)

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "ModelSchema":
        return cls(**json.loads(text))


class FaultToleranceUtils:
    @staticmethod
    def retry_with_timeout(fn: Callable[[], T], times: int = 3,
                           backoff: float = 0.5,
                           sleep: Optional[Callable[[float], None]] = None) -> T:
        """``FaultToleranceUtils.retryWithTimeout``
        (``ModelDownloader.scala:37-52``), now a thin shim over the shared
        :class:`~mmlspark_tpu_torch.resilience.policy.RetryPolicy` — seeded
        full-jitter backoff replaces the bare ``backoff * 2**attempt``
        (synchronized download retries from a fleet otherwise re-collide),
        and a tighter ambient deadline/retry budget is honored for free."""
        from mmlspark_tpu_torch.resilience.policy import RetryPolicy

        policy = RetryPolicy(
            max_attempts=times, base=backoff, seed=0,
            sleep=sleep if sleep is not None else time.sleep,
        )
        return policy.run(fn, describe="model download")


class Repository:
    """Abstract model store (``Repository`` trait)."""

    def list_schemas(self) -> Iterator[ModelSchema]:
        raise NotImplementedError

    def get_bytes(self, schema: ModelSchema) -> bytes:
        raise NotImplementedError


class LocalRepo(Repository):
    """Directory of ``<name>.json`` schemas next to model payloads — the
    ``HDFSRepo`` role for local/mounted filesystems."""

    def __init__(self, path: str):
        self.path = path

    def list_schemas(self) -> Iterator[ModelSchema]:
        if not os.path.isdir(self.path):
            return
        for fname in sorted(os.listdir(self.path)):
            if fname.endswith(".json"):
                with open(os.path.join(self.path, fname)) as f:
                    yield ModelSchema.from_json(f.read())

    def get_bytes(self, schema: ModelSchema) -> bytes:
        uri = schema.uri
        path = uri[7:] if uri.startswith("file://") else uri
        if not os.path.isabs(path):
            path = os.path.join(self.path, path)
        with open(path, "rb") as f:
            return f.read()

    def add(self, schema: ModelSchema, payload: bytes) -> None:
        os.makedirs(self.path, exist_ok=True)
        with open(os.path.join(self.path, f"{schema.name}.bin"), "wb") as f:
            f.write(payload)
        schema.uri = f"{schema.name}.bin"
        schema.hash = hashlib.sha256(payload).hexdigest()
        schema.size = len(payload)
        with open(os.path.join(self.path, f"{schema.name}.json"), "w") as f:
            f.write(schema.to_json())


class RemoteRepo(Repository):
    """HTTP repo (``DefaultModelRepo`` over the CDN): an index JSON listing
    schemas; payloads fetched by uri with retries."""

    def __init__(self, base_url: str):
        self.base_url = base_url.rstrip("/")

    def list_schemas(self) -> Iterator[ModelSchema]:
        import urllib.request

        def fetch():
            with urllib.request.urlopen(f"{self.base_url}/index.json", timeout=30) as r:
                return json.loads(r.read())

        for entry in FaultToleranceUtils.retry_with_timeout(fetch):
            yield ModelSchema(**entry)

    def get_bytes(self, schema: ModelSchema) -> bytes:
        import urllib.request

        url = schema.uri
        if not url.startswith(("http://", "https://")):
            url = f"{self.base_url}/{url}"

        def fetch():
            with urllib.request.urlopen(url, timeout=120) as r:
                return r.read()

        return FaultToleranceUtils.retry_with_timeout(fetch)


class ModelDownloader:
    """Downloads models from a repo into a local cache dir, verifying hashes
    (``ModelDownloader.scala:210+``)."""

    def __init__(self, local_path: str, repo: Optional[Repository] = None):
        self.local_path = local_path
        self.repo = repo if repo is not None else LocalRepo(local_path)

    def list_models(self) -> List[ModelSchema]:
        return list(self.repo.list_schemas())

    def download_by_name(self, name: str) -> str:
        for schema in self.repo.list_schemas():
            if schema.name == name:
                return self.download_model(schema)
        raise KeyError(f"no model named {name!r} in repository")

    def download_model(self, schema: ModelSchema) -> str:
        """Returns the local path of the (cached) payload."""
        os.makedirs(self.local_path, exist_ok=True)
        dest = os.path.join(self.local_path, f"{schema.name}.bin")
        if os.path.exists(dest) and schema.hash:
            with open(dest, "rb") as f:
                if hashlib.sha256(f.read()).hexdigest() == schema.hash:
                    return dest
        payload = self.repo.get_bytes(schema)
        if schema.hash:
            got = hashlib.sha256(payload).hexdigest()
            if got != schema.hash:
                raise IOError(
                    f"hash mismatch for {schema.name}: want {schema.hash}, got {got}"
                )
        with open(dest, "wb") as f:
            f.write(payload)
        return dest
