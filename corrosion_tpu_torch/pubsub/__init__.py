"""Live-query (subscriptions) and raw-update notification engines.

The port's copy of `corrosion_tpu/pubsub/__init__.py`.

Counterpart of `klukai-types/src/pubsub.rs` (SubsManager/Matcher, the
reference's largest single component) and `klukai-types/src/updates.rs`
(UpdatesManager).
"""

from corrosion_tpu_torch.pubsub.manager import SubsManager
from corrosion_tpu_torch.pubsub.matcher import Matcher, MatcherHandle
from corrosion_tpu_torch.pubsub.updates import UpdatesManager

__all__ = ["SubsManager", "Matcher", "MatcherHandle", "UpdatesManager"]
