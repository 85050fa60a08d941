"""``pw.io.minio``: MinIO speaks the S3 protocol; ``read`` and ``write`` are
``pw.io.s3``'s over ``MinIOSettings`` (counterpart of ``pathway_tpu/io/minio.py``)."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.io import s3 as _s3


class MinIOSettings:
    def __init__(
        self,
        endpoint: str,
        bucket_name: str,
        access_key: str,
        secret_access_key: str,
        *,
        with_path_style: bool = True,
    ) -> None:
        self.settings = _s3.AwsS3Settings(
            bucket_name=bucket_name,
            access_key=access_key,
            secret_access_key=secret_access_key,
            endpoint=endpoint,
            with_path_style=with_path_style,
        )


def read(path: str, minio_settings: MinIOSettings | None = None, **kwargs: Any):
    settings = minio_settings.settings if minio_settings else None
    return _s3.read(path, aws_s3_settings=settings, **kwargs)


def write(table, path: str, minio_settings: MinIOSettings | None = None, **kwargs: Any):
    settings = minio_settings.settings if minio_settings else None
    return _s3.write(table, path, aws_s3_settings=settings, **kwargs)
