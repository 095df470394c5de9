"""Data reader/writer abstractions.

API-compatible with the reference data layer
(reference: rapid_doc/data/data_reader_writer/base.py, filebase.py,
s3.py, multi_bucket_s3.py, io/http.py): same class names and method
shapes so downstream code ports over unchanged. Port of the JAX
package's module: ``HttpReader`` downloads with ``urllib.request`` (the
JAX package uses ``requests``) and asks for a byte range with a
``Range`` header, slicing the body itself where the server sends it
whole; ``http_get`` raises ``HttpStatusError`` (an ``OSError``) with
the message ``requests``' ``raise_for_status`` gives. S3 needs
``boto3``, imported when a client is made, as in the JAX package.
"""
from __future__ import annotations

import os
from abc import ABC, abstractmethod
from dataclasses import dataclass
from pathlib import Path


@dataclass(frozen=True)
class S3Config:
    """Credentials + endpoint for one bucket (reference:
    rapid_doc/data/utils/schemas.py S3Config)."""

    bucket_name: str
    access_key: str
    secret_key: str
    endpoint_url: str
    addressing_style: str = "auto"


def parse_s3path(path: str) -> tuple[str, str]:
    """'s3://bucket/a/b.pdf' -> ('bucket', 'a/b.pdf')."""
    if not path.startswith("s3://"):
        raise ValueError(f"not an s3 path: {path}")
    rest = path[len("s3://"):]
    bucket, _, key = rest.partition("/")
    if not bucket:
        raise ValueError(f"no bucket in s3 path: {path}")
    return bucket, key


def parse_s3_range(path: str) -> tuple[str, int, int]:
    """Split the reference's '?offset,limit' suffix off an s3 path:
    's3://b/k?100,50' -> ('s3://b/k', 100, 50); no suffix -> (path, 0, -1)."""
    base, _, query = path.partition("?")
    if not query:
        return path, 0, -1
    parts = query.split(",")
    if len(parts) != 2:
        return base, 0, -1
    try:
        return base, int(parts[0]), int(parts[1])
    except ValueError:
        return base, 0, -1


class DataReader(ABC):
    def read(self, path: str) -> bytes:
        return self.read_at(path)

    @abstractmethod
    def read_at(self, path: str, offset: int = 0, limit: int = -1) -> bytes:
        ...


class DataWriter(ABC):
    @abstractmethod
    def write(self, path: str, data: bytes) -> None:
        ...

    def write_string(self, path: str, data: str) -> None:
        self.write(path, data.encode("utf-8"))


class FileBasedDataReader(DataReader):
    def __init__(self, parent_dir: str = ""):
        self._parent_dir = parent_dir

    def read_at(self, path: str, offset: int = 0, limit: int = -1) -> bytes:
        fn = path if os.path.isabs(path) else os.path.join(self._parent_dir, path)
        with open(fn, "rb") as f:
            f.seek(offset)
            return f.read() if limit == -1 else f.read(limit)


class FileBasedDataWriter(DataWriter):
    def __init__(self, parent_dir: str = ""):
        self._parent_dir = parent_dir

    def write(self, path: str, data: bytes) -> None:
        fn = path if os.path.isabs(path) else os.path.join(self._parent_dir, path)
        Path(fn).parent.mkdir(parents=True, exist_ok=True)
        with open(fn, "wb") as f:
            f.write(data)


class MemoryDataWriter(DataWriter):
    def __init__(self, parent_dir: str = "images") -> None:
        self._parent_dir = parent_dir
        self.data: dict[str, bytes] = {}

    def write(self, path: str, data: bytes) -> None:
        self.data[path.replace("\\", "/")] = data

    def get_value(self) -> dict[str, bytes]:
        return self.data


class FanoutDataWriter(DataWriter):
    def __init__(self, *writers: DataWriter | None) -> None:
        self._writers = [w for w in writers if w is not None]
        self._parent_dir = next(
            (getattr(w, "_parent_dir", "") for w in self._writers
             if getattr(w, "_parent_dir", "")),
            "",
        )

    def write(self, path: str, data: bytes) -> None:
        for w in self._writers:
            w.write(path, data)


class DummyDataWriter(DataWriter):
    def write(self, path: str, data: bytes) -> None:
        pass


class HttpStatusError(OSError):
    """A response status of 400 or above, worded as ``requests``'
    ``raise_for_status`` words it."""


def http_get(url: str, timeout: float = 60, offset: int = 0, limit: int = -1) -> bytes:
    """The body at ``url`` (bytes ``offset`` to ``offset + limit``, all
    of it from ``offset`` for ``limit == -1``)."""
    import urllib.error
    import urllib.request

    headers = {}
    if offset or limit != -1:
        end = "" if limit == -1 else offset + limit - 1
        headers["Range"] = f"bytes={offset}-{end}"
    req = urllib.request.Request(url, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            data = resp.read()
            partial = resp.status == 206
    except urllib.error.HTTPError as e:
        kind = "Client" if e.code < 500 else "Server"
        raise HttpStatusError(f"{e.code} {kind} Error: {e.reason} for url: {url}") from None
    if headers and not partial:
        data = data[offset:None if limit == -1 else offset + limit]
    return data


class HttpReader(DataReader):
    def read_at(self, path: str, offset: int = 0, limit: int = -1) -> bytes:
        return http_get(path, offset=offset, limit=limit)


def _make_s3_client(ak: str, sk: str, endpoint: str,
                    addressing_style: str = "auto"):
    try:
        import boto3  # type: ignore
        from botocore.config import Config  # type: ignore
    except ImportError as e:  # pragma: no cover
        raise RuntimeError("boto3 is not available in this environment") from e
    return boto3.client(
        "s3", aws_access_key_id=ak, aws_secret_access_key=sk,
        endpoint_url=endpoint,
        config=Config(s3={"addressing_style": addressing_style},
                      retries={"max_attempts": 3}),
    )


class S3DataReader(DataReader):
    """Single-bucket S3 reader; requires boto3."""

    def __init__(self, bucket: str, ak: str, sk: str, endpoint: str,
                 parent_dir: str = "", addressing_style: str = "auto"):
        self._client = _make_s3_client(ak, sk, endpoint, addressing_style)
        self._bucket = bucket
        self._parent = parent_dir

    def read_at(self, path: str, offset: int = 0, limit: int = -1) -> bytes:
        key = os.path.join(self._parent, path) if self._parent else path
        kwargs = {}
        if offset or limit != -1:
            end = "" if limit == -1 else offset + limit - 1
            kwargs["Range"] = f"bytes={offset}-{end}"
        obj = self._client.get_object(Bucket=self._bucket, Key=key, **kwargs)
        return obj["Body"].read()


class S3DataWriter(DataWriter):
    def __init__(self, bucket: str, ak: str, sk: str, endpoint: str,
                 parent_dir: str = "", addressing_style: str = "auto"):
        self._client = _make_s3_client(ak, sk, endpoint, addressing_style)
        self._bucket = bucket
        self._parent = parent_dir

    def write(self, path: str, data: bytes) -> None:
        key = os.path.join(self._parent, path) if self._parent else path
        self._client.put_object(Bucket=self._bucket, Key=key, Body=data)


class _MultiBucketS3Base:
    """Route each request to a per-bucket client (reference:
    data/data_reader_writer/multi_bucket_s3.py:21-143). Absolute
    `s3://bucket/key` paths pick the client by bucket; relative paths go
    to the default bucket under the default prefix. Clients are built
    lazily so boto3 is only required when S3 is actually touched."""

    _cls: type  # S3DataReader or S3DataWriter, set by subclass

    def __init__(self, default_prefix: str, s3_configs: list[S3Config]):
        if not default_prefix:
            raise ValueError("default_prefix must be provided")
        parts = default_prefix.strip("/").split("/")
        self.default_bucket = parts[0]
        self.default_prefix = "/".join(parts[1:])
        names = [c.bucket_name for c in s3_configs]
        if len(set(names)) != len(names):
            raise ValueError(f"bucket_name must be unique: {names}")
        if self.default_bucket not in names:
            raise ValueError(
                f"default bucket {self.default_bucket!r} has no config "
                f"(configured: {names})"
            )
        self._configs = {c.bucket_name: c for c in s3_configs}
        self._clients: dict[str, object] = {}

    def _client_for(self, bucket: str):
        if bucket not in self._configs:
            raise ValueError(
                f"bucket {bucket!r} not configured "
                f"(configured: {sorted(self._configs)})"
            )
        if bucket not in self._clients:
            c = self._configs[bucket]
            self._clients[bucket] = self._cls(
                bucket, c.access_key, c.secret_key, c.endpoint_url,
                addressing_style=c.addressing_style,
            )
        return self._clients[bucket]

    def _route(self, path: str) -> tuple[object, str]:
        if path.startswith("s3://"):
            bucket, key = parse_s3path(path)
            return self._client_for(bucket), key
        key = (
            f"{self.default_prefix}/{path}" if self.default_prefix else path
        )
        return self._client_for(self.default_bucket), key


class MultiBucketS3DataReader(_MultiBucketS3Base, DataReader):
    _cls = S3DataReader

    def read(self, path: str) -> bytes:
        # reference supports 's3://bucket/key?offset,limit' range reads
        base, offset, limit = parse_s3_range(path)
        return self.read_at(base, offset, limit)

    def read_at(self, path: str, offset: int = 0, limit: int = -1) -> bytes:
        client, key = self._route(path)
        return client.read_at(key, offset, limit)  # type: ignore[attr-defined]


class MultiBucketS3DataWriter(_MultiBucketS3Base, DataWriter):
    _cls = S3DataWriter

    def write(self, path: str, data: bytes) -> None:
        client, key = self._route(path)
        client.write(key, data)  # type: ignore[attr-defined]
