/* Shared i18n for the built-in web UI.
   Reference: web_ui/src/plugins/i18n.js + i18n-en.js/i18n-zh.js (react-
   i18next en/zh dictionaries, toggled by appbar/LocaleMenu.jsx).  Here the
   same en/zh capability is one shared dict keyed by the English source
   string; elements opt in with data-i18n (textContent) or data-i18n-title
   (title attribute), and pages re-apply on toggle. */
"use strict";
const LSD_ZH = {
  /* navigation */
  "Home": "主页", "Preview": "预览", "Status": "状态", "Config": "配置",
  "Map": "地图", "Dev": "开发", "Editor": "编辑器 ↗", "Calib": "标定 ↗",
  "Upgrade": "升级 ↗", "TViz": "遥测",
  /* home */
  "Start record": "开始记录", "Stop record": "停止记录", "module": "模块",
  "frames": "帧数", "drops": "丢帧", "alive": "存活", "latency ms": "延迟 ms",
  "Time": "时间", "Disk": "磁盘", "of": "/", "none": "无",
  "Running": "运行中", "Paused": "已暂停", "unreachable": "无法连接",
  /* preview / player */
  "step": "单步", "height": "高度", "intensity": "强度", "follow": "跟随",
  "labels": "标签", "freespace": "可行域", "include": "包含",
  "exclude": "排除", "ROI": "感兴趣区",
  /* config */
  "Reload": "重新加载", "Apply": "应用", "Restore defaults": "恢复默认",
  "Form view": "表单视图", "JSON view": "JSON 视图",
  "loaded": "已加载", "applied": "已应用",
  /* graph / map */
  "Refresh": "刷新", "Optimize": "优化", "Save map": "保存地图",
  "vertex": "顶点", "fixed": "固定",
  /* tviz */
  "Channels": "通道", "Poll once": "采样一次", "Clear": "清除",
  "▶ Auto": "▶ 自动", "⏸ Stop": "⏸ 停止", "all (first 6)": "全部（前6项）",
  "samples": "样本",
  /* dev page (ref web_ui components/dev) */
  "Log": "日志", "Board config": "设备参数", "Functions": "功能选择",
  "Set level": "设置级别", "auto": "自动", "Thread dump": "线程转储",
  "Load file": "加载文件", "Download": "下载", "recent": "最近",
  "Reset": "重置", "Update": "更新",
  "Config updated": "配置已更新", "Config reset": "配置已重置",
  "Saved": "已保存",
  "Reboot required to apply — reboot now?":
    "配置已更新，需要重启才能生效 — 现在重启吗？",
  /* store / avfuns (ref web_ui components/store + dev/SelectFunctions) */
  "config": "配置", "calibration": "标定",
  "device": "设备信息", "lidar": "激光设置", "camera": "相机设置",
  "radar": "雷达设置", "ins": "INS 设置", "detect": "目标检测",
  "slam": "建图定位", "output": "输出方式", "advance": "高级选项",
  "calibrate_lidar": "激光标定", "calibrate_camera": "相机标定",
  "calibrate_lidar_camera": "激光-相机标定",
  "calibrate_lidar_ins": "激光-INS 标定",
  "calibrate_lidar_imu": "激光-IMU 标定",
  "calibrate_panorama_camera": "全景相机标定",
  /* editor */
  "File ▾": "文件 ▾", "Graph ▾": "位姿图 ▾", "View ▾": "视图 ▾",
  "Open map…": "打开地图…", "Merge map…": "合并地图…",
  "Save map…": "保存地图…", "Export PCD": "导出 PCD",
  "Reload from session": "从会话重新加载",
  "Delete selected vertices": "删除所选顶点",
  "Manual loop (2 selected)": "手动回环（选中2个）",
  "Fix selected": "固定所选", "Unfix selected": "取消固定所选",
  "Clear selection": "清除选择", "Reverse selection": "反选",
  "Top-down view": "俯视图",
  "Save": "保存", "OK": "确定", "Cancel": "取消", "Add": "添加",
  "Add edge": "添加边", "Auto align": "自动配准", "Del points": "删除点",
  "Delete vertex": "删除顶点", "Toggle fixed": "切换固定",
  "Loop begin": "回环起点", "Loop end": "回环终点", "Navigate": "浏览",
  "Select": "选择", "Area": "区域", "custom": "自定义",
  "no_detect": "禁止检测", "no_mapping": "禁止建图", "speed_limit": "限速",
  /* calibration */
  "Lidar": "激光", "Camera": "相机", "Lidar-Camera": "激光-相机",
  "Lidar-INS": "激光-INS", "Lidar-IMU": "激光-IMU", "Panorama": "全景",
  "Calibrate": "标定", "Calibrate extrinsic": "标定外参",
  "Calibrate intrinsics": "标定内参", "Capture corners": "捕获角点",
  "Clear pairs": "清除配对", "Draw ground polygon": "绘制地面多边形",
  "Pick source points": "选择源点", "Reset shots": "重置采样",
  "Restart collection": "重新采集", "Show panorama": "显示全景",
  "Solve homography": "求解单应", "Apply heading": "应用航向",
  "Apply to config": "应用到配置",
  "src x": "源 x", "src y": "源 y", "tgt x": "目标 x", "tgt y": "目标 y",
  /* upgrade */
  "Power off": "关机", "Reboot": "重启", "Upload & upgrade": "上传并升级",
  "View log": "查看日志", "idle": "空闲", "Firmware upgrade": "固件升级",
  "Device version": "设备版本", "back": "返回",
};
/* alias keys: data-i18n ids that are not themselves the English text
   (long help sentences); both languages resolve through the dicts */
const LSD_EN = {
  "roi-help": "draw a ground ROI polygon (click to add, double-click to " +
              "finish, Esc to cancel)",
  "ground-help": "Draw a polygon on flat ground (click points, Enter to " +
                 "apply, Esc cancels).",
  "heading-help": "Click cloud points to collect source XY; edit targets; " +
                  "Apply solves the 2D rotation+translation.",
  "lc-help": "Click a 2D pixel in the image, then the matching 3D point " +
             "in the cloud. ≥4 pairs, then Calibrate.",
  "ins-help": "Start a mapping drive with RTK fixes, restart the " +
              "collection, and watch both trajectories; calibrate aligns " +
              "them (Umeyama).",
  "imu-help": "Hand-eye calibration from relative motions during an " +
              "excited drive (rotation-rich).",
  "pano-help": "Click ≥4 matching points alternately in A then B.",
  "loop-help": "The main view shows the target keyframe (gray) and the " +
               "source keyframe (colored) under the current relative " +
               "guess. Auto align refines it with point-to-plane ICP on " +
               "the backend.",
};
Object.assign(LSD_ZH, {
  "roi-help": "绘制地面 ROI 多边形（点击添加，双击完成，Esc 取消）",
  "ground-help": "在平坦地面上绘制多边形（点击加点，Enter 应用，Esc 取消）。",
  "heading-help": "点击点云采集源 XY；编辑目标值；应用求解 2D 旋转+平移。",
  "lc-help": "先点击图像中的 2D 像素，再点击点云中对应的 3D 点。≥4 对后标定。",
  "ins-help": "以 RTK 固定解开始建图行驶，重新采集并观察两条轨迹；标定执行 "
              + "Umeyama 对齐。",
  "imu-help": "在激励（富旋转）行驶中由相对运动做手眼标定。",
  /* table/label vocabulary */
  "fps": "帧率", "latency ms": "延迟 ms",
  "100 samples": "100 样本", "300 samples": "300 样本",
  "1000 samples": "1000 样本", "3000 samples": "3000 样本",
  "color": "颜色", "z min": "z 下限", "z max": "z 上限",
  "pt size": "点大小", "budget": "点数预算", "name": "名称",
  "root": "根目录", "type": "类型",
  "index": "序号", "extrinsic": "外参", "cols": "列数", "rows": "行数",
  "square m": "方格边长 m", "camera": "相机",
  "camera A": "相机 A", "camera B": "相机 B",
  "pano-help": "在 A、B 两图中交替点击 ≥4 对匹配点。",
  "loop-help": "主视图显示当前相对位姿猜测下的目标关键帧（灰色）与源关键帧"
               + "（彩色）。自动配准在后端用点到面 ICP 细化。",
});
let lsdLang = (function () {
  try { return localStorage.getItem("lsd_lang") || "en"; }
  catch (e) { return "en"; }
})();
function tr(s) {
  if (lsdLang === "zh") return LSD_ZH[s] || LSD_EN[s] || s;
  return LSD_EN[s] || s;
}
function applyLang() {
  document.querySelectorAll("[data-i18n]").forEach(el => {
    el.textContent = tr(el.dataset.i18n);
  });
  document.querySelectorAll("[data-i18n-title]").forEach(el => {
    el.title = tr(el.dataset.i18nTitle);
  });
  const l = document.getElementById("lang");
  if (l) l.textContent = lsdLang === "zh" ? "EN" : "中文";
}
function bindLang() {
  const l = document.getElementById("lang");
  if (!l) return;
  l.onclick = () => {
    lsdLang = lsdLang === "zh" ? "en" : "zh";
    try { localStorage.setItem("lsd_lang", lsdLang); } catch (e) {}
    applyLang();
    if (window.onLangChange) window.onLangChange();
  };
}
