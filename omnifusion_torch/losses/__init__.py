from omnifusion_torch.losses.direct import berhu_loss, l1_loss

__all__ = ["berhu_loss", "l1_loss"]
