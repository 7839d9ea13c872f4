from .vocabulary import Vocabulary, build_vocabulary, load_orbvoc_text  # noqa: F401
