"""The licensed connectors: SharePoint."""

from pathway_tpu_torch.xpacks.connectors import sharepoint  # noqa: F401
