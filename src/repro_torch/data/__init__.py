"""Synthetic data pipeline: token streams, image frames, request loads."""

from .pipeline import (TokenStream, ImageStream, RequestStream,
                       synthetic_token_batch)

__all__ = ["TokenStream", "ImageStream", "RequestStream",
           "synthetic_token_batch"]
