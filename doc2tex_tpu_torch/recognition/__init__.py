from .flow import MathRecognition, load_recog_config

__all__ = ["MathRecognition", "load_recog_config"]
