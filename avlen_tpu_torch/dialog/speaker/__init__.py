from avlen_tpu_torch.dialog.speaker.speaker import Speaker
from avlen_tpu_torch.dialog.speaker.vocab import Vocabulary

__all__ = ["Speaker", "Vocabulary"]
