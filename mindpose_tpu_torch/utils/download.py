"""Download utility: md5-checked fetch + archive extraction.

A copy of ``mindpose_tpu/utils/download.py`` (stdlib only), which
``utils/checkpoint.load_pretrained_backbone`` fetches an ``http(s)://``
backbone with; tests/test_torch_host_copies.py pins it to the original.
"""
import bz2
import gzip
import hashlib
import logging
import os
import ssl
import tarfile
import urllib.error
import urllib.request
import zipfile
from typing import Optional

__all__ = ["DownLoad", "get_default_download_root"]


def get_default_download_root() -> str:
    return os.path.join(os.path.expanduser("~"), ".mindpose_tpu")


class DownLoad:
    """Download + verify + extract helper."""

    USER_AGENT = "mindpose_tpu"

    @staticmethod
    def calculate_md5(file_path: str, chunk_size: int = 1024 * 1024) -> str:
        md5 = hashlib.md5()
        with open(file_path, "rb") as f:
            for chunk in iter(lambda: f.read(chunk_size), b""):
                md5.update(chunk)
        return md5.hexdigest()

    def check_md5(self, file_path: str, md5: Optional[str] = None) -> bool:
        return md5 is None or md5 == self.calculate_md5(file_path)

    @staticmethod
    def extract_tar(from_path: str, to_path: Optional[str] = None) -> None:
        with tarfile.open(from_path, "r:*") as tar:
            tar.extractall(to_path)

    @staticmethod
    def extract_zip(from_path: str, to_path: Optional[str] = None) -> None:
        with zipfile.ZipFile(from_path, "r") as archive:
            archive.extractall(to_path)

    @staticmethod
    def extract_gz_or_bz2(from_path: str, to_path: Optional[str] = None) -> None:
        opener = gzip.open if from_path.endswith(".gz") else bz2.open
        target = os.path.splitext(from_path)[0]
        if to_path:
            target = os.path.join(to_path, os.path.basename(target))
        with opener(from_path, "rb") as src, open(target, "wb") as dst:
            dst.write(src.read())

    def extract_archive(self, from_path: str, to_path: Optional[str] = None) -> None:
        if from_path.endswith((".tar", ".tar.gz", ".tgz", ".tar.bz2")):
            self.extract_tar(from_path, to_path)
        elif from_path.endswith(".zip"):
            self.extract_zip(from_path, to_path)
        elif from_path.endswith((".gz", ".bz2")):
            self.extract_gz_or_bz2(from_path, to_path)
        else:
            raise ValueError(f"Unsupported archive: {from_path}")

    def download_url(
        self,
        url: str,
        path: Optional[str] = None,
        filename: Optional[str] = None,
        md5: Optional[str] = None,
    ) -> str:
        """Download ``url`` to ``path/filename`` (md5-verified, cached).

        Falls back from https to http like the reference (:download.py).
        """
        path = path or get_default_download_root()
        os.makedirs(path, exist_ok=True)
        filename = filename or os.path.basename(url)
        file_path = os.path.join(path, filename)

        if os.path.isfile(file_path) and self.check_md5(file_path, md5):
            return file_path

        def fetch(u):
            req = urllib.request.Request(u, headers={"User-Agent": self.USER_AGENT})
            ctx = ssl.create_default_context()
            with urllib.request.urlopen(req, context=ctx) as resp, open(
                file_path, "wb"
            ) as out:
                out.write(resp.read())

        try:
            fetch(url)
        except (urllib.error.URLError, OSError) as e:
            if url.startswith("https"):
                logging.warning("https failed (%s); retrying over http", e)
                fetch(url.replace("https:", "http:", 1))
            else:
                raise
        if not self.check_md5(file_path, md5):
            raise RuntimeError(f"md5 mismatch for {file_path}")
        return file_path

    def download_and_extract_archive(
        self,
        url: str,
        download_path: Optional[str] = None,
        extract_path: Optional[str] = None,
        filename: Optional[str] = None,
        md5: Optional[str] = None,
    ) -> None:
        file_path = self.download_url(url, download_path, filename, md5)
        self.extract_archive(file_path, extract_path)
