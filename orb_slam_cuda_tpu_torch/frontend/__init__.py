from .extractor import ORBExtractor, ExtractorConfig, Features  # noqa: F401
