from .vocabulary import Vocabulary, build_vocabulary  # noqa: F401
